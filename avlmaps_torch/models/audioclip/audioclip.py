"""AudioCLIP: audio embeddings in the CLIP joint space.

Counterpart of ``avlmaps_tpu/models/audioclip/audioclip.py`` (reference
avlmaps/audioclip/model/audioclip.py): CLIP with a 1024-d embedding and a
512-wide, 12-layer text tower, the ESResNeXt-FBSP audio tower, the RN50
image tower and two more learned logit scales (audio-image, audio-text,
initialised to log 100 and clamped to [1, 100] at use).  The text tower
is the port's CLIP :class:`TextEncoder`.

The audio and image towers are f32 convolution stacks; cuDNN computes f32
convolutions in TF32 unless told otherwise (``torch.backends.cudnn.
allow_tf32`` is True out of the box), which the log-power front end
would magnify.  Every forward here runs under ``utils.device.full_f32``,
which switches TF32 off for cuDNN and cuBLAS for its duration only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from avlmaps_torch.models.audioclip.esresnet import (ESResNeXtConfig,
                                                     ESResNeXtFBSP)
from avlmaps_torch.models.audioclip.modified_resnet import (
    ModifiedResNet, ModifiedResNetConfig)
from avlmaps_torch.models.clip.model import ClipConfig, TextEncoder
from avlmaps_torch.models.clip.tokenizer import default_tokenizer
from avlmaps_torch.utils.device import full_f32, resolve_device, to_device


@dataclasses.dataclass(frozen=True)
class AudioClipConfig:
    embed_dim: int = 1024
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    context_length: int = 77
    vocab_size: int = 49408
    audio: ESResNeXtConfig = ESResNeXtConfig()
    vision: ModifiedResNetConfig = ModifiedResNetConfig()

    def text_config(self) -> ClipConfig:
        return ClipConfig(embed_dim=self.embed_dim,
                          text_width=self.text_width,
                          text_layers=self.text_layers,
                          text_heads=self.text_heads,
                          context_length=self.context_length,
                          vocab_size=self.vocab_size)

    @staticmethod
    def tiny() -> "AudioClipConfig":
        return AudioClipConfig(embed_dim=16, text_width=32, text_layers=2,
                               text_heads=2, context_length=16,
                               audio=ESResNeXtConfig.tiny(),
                               vision=ModifiedResNetConfig.tiny())


class AudioClip(nn.Module):
    """Audio, text and image towers with the reference's logit scales.
    Parameters are created on ``device`` (default ``"cuda"``; raises
    without a card; ``"meta"`` for shapes only)."""

    def __init__(self, cfg: AudioClipConfig,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.cfg = cfg
        dev = device if str(device) == "meta" else resolve_device(device)
        with torch.device(dev):
            self.audio = ESResNeXtFBSP(dataclasses.replace(
                cfg.audio, num_classes=cfg.embed_dim))
            self.text = TextEncoder(cfg.text_config())
            self.visual = ModifiedResNet(dataclasses.replace(
                cfg.vision, embed_dim=cfg.embed_dim))
            self.logit_scale = nn.Parameter(
                torch.tensor(float(np.log(1 / 0.07))))
            self.logit_scale_ai = nn.Parameter(
                torch.tensor(float(np.log(100.0))))
            self.logit_scale_at = nn.Parameter(
                torch.tensor(float(np.log(100.0))))

    def encode_audio(self, audio: torch.Tensor) -> torch.Tensor:
        with full_f32():
            return self.audio(audio)

    def encode_text(self, token_ids: torch.Tensor) -> torch.Tensor:
        with full_f32():
            return self.text(token_ids)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        with full_f32():
            return self.visual(images)

    def forward(self, audio: torch.Tensor,
                token_ids: torch.Tensor) -> torch.Tensor:
        """Audio-text logits (reference forward :139-196, the audio-text
        pair): clamp(exp(logit_scale_at), 1, 100) * A_norm @ T_norm^T."""
        af = self.encode_audio(audio)
        tf = self.encode_text(token_ids)
        af = af / torch.linalg.vector_norm(af, dim=-1, keepdim=True)
        tf = tf / torch.linalg.vector_norm(tf, dim=-1, keepdim=True)
        scale = torch.clamp(torch.exp(self.logit_scale_at), 1.0, 100.0)
        with full_f32():
            return scale * af @ tf.T

    def tri_modal(self, audio: torch.Tensor, images: torch.Tensor,
                  token_ids: torch.Tensor):
        """All three pairwise logit matrices (reference AudioCLIP.forward,
        audioclip.py:139-196): (audio x image, audio x text, image x text),
        each pair with its clamped scale."""
        def norm(z):
            return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)

        af = norm(self.encode_audio(audio))
        vf = norm(self.encode_image(images))
        tf = norm(self.encode_text(token_ids))
        s_ai, s_at, s_it = (torch.clamp(torch.exp(s), 1.0, 100.0) for s in (
            self.logit_scale_ai, self.logit_scale_at, self.logit_scale))
        with full_f32():
            return s_ai * af @ vf.T, s_at * af @ tf.T, s_it * vf @ tf.T


class AudioClipEncoder:
    """AudioCLIP on ``device`` (default ``"cuda"``; raises without a card)
    with the feature APIs the sound map uses: audio features are
    L2-normalised when the map is built (reference
    audio_utils.encode_audio_batch) and scored against text with the
    clamped logit scale (sound_map.py:102-153).

    ``params`` is a state_dict of :class:`AudioClip` (``port.
    params_from_flax`` or ``port.load_audioclip_checkpoint``);
    ``params=None`` draws seeded random weights at ``cfg``'s width (no
    AudioCLIP checkpoint is part of the repository)."""

    SAMPLE_LEN = 220500  # 5 s at 44.1 kHz (reference sound_map.py:41-47)

    def __init__(self, cfg: Optional[AudioClipConfig] = None, params=None,
                 seed: int = 0, tokenizer=None,
                 device: Union[str, torch.device] = "cuda"):
        from avlmaps_torch.models.audioclip.port import init_params

        self.device = resolve_device(device)
        self.cfg = cfg or AudioClipConfig()
        self.tokenizer = tokenizer or default_tokenizer()
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = init_params(self.cfg, gen)
        self.model = AudioClip(self.cfg, device=self.device)
        self.model.load_state_dict(params, strict=True)
        self.model.eval().requires_grad_(False)

    def _sample_len(self) -> int:
        # tiny configs use a shorter probe signal
        return 2048 if self.cfg.audio.n_fft < 256 else self.SAMPLE_LEN

    def prepare_audio(self, audio: np.ndarray,
                      out_len: Optional[int] = None) -> np.ndarray:
        """Centred zero padding or centred crop to the fixed sample length
        (eval-mode semantics of the reference's RandomPadding/RandomCrop,
        audioclip/utils/transforms.py:64-199)."""
        out_len = out_len or self._sample_len()
        t = audio.shape[-1]
        if t < out_len:
            extra = out_len - t
            left = extra // 2
            audio = np.pad(audio, [(0, 0)] * (audio.ndim - 1)
                           + [(left, extra - left)])
        elif t > out_len:
            left = (t - out_len) // 2
            audio = audio[..., left:left + out_len]
        return audio

    @torch.no_grad()
    def encode_audio_device(self, batch: np.ndarray) -> torch.Tensor:
        """(B, T) prepared clips -> (B, embed_dim) raw embeddings on the
        device."""
        return self.model.encode_audio(to_device(batch, self.device,
                                                 torch.float32))

    def encode_audio_batch(self, clips: Sequence[np.ndarray],
                           batch_size: int = 10) -> np.ndarray:
        """L2-normalised audio embeddings (reference
        audio_utils.encode_audio_batch :602-648): batches of 10, the last
        one filled up with copies of its last clip."""
        prepared = np.stack([self.prepare_audio(np.asarray(c, np.float32))
                             for c in clips])
        out = np.zeros((len(clips), self.cfg.embed_dim), np.float32)
        for s in range(0, len(clips), batch_size):
            chunk = prepared[s:s + batch_size]
            pad = batch_size - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.tile(chunk[-1:],
                                                       (pad, 1))])
            feats = self.encode_audio_device(chunk).cpu().numpy()
            feats = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
            out[s:s + batch_size] = feats[:batch_size - pad]
        return out

    @torch.no_grad()
    def encode_text(self, texts: Sequence) -> np.ndarray:
        """L2-normalised text embeddings (reference AudioCLIP.encode_text:
        entity lists joined with ', ')."""
        joined = [", ".join(t) if isinstance(t, (list, tuple)) else t
                  for t in texts]
        tokens = self.tokenizer(joined, self.cfg.context_length)
        feats = self.model.encode_text(
            to_device(tokens, self.device)).cpu().numpy()
        return feats / np.linalg.norm(feats, axis=-1, keepdims=True)

    def audio_text_logits(self, audio_feats: np.ndarray,
                          text_feats: np.ndarray) -> np.ndarray:
        """scale_at * A @ T^T with the clamped learned scale (reference
        sound_map.py:107-114), on the host."""
        scale = float(np.clip(np.exp(
            self.model.logit_scale_at.detach().cpu().numpy()), 1.0, 100.0))
        return scale * audio_feats @ text_feats.T

