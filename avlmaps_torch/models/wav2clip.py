"""Wav2CLIP, the alternative audio encoder (the reference's ablation
path), in PyTorch.

Counterpart of ``avlmaps_tpu/models/wav2clip.py``.  The reference embeds
sound clips with the pip ``wav2clip`` package -- a log-mel-spectrogram
ResNet-18 distilled into CLIP's joint space -- and scores them against
CLIP ViT-B/32 text features (avlmaps/utils/audio_utils.py:695-735):

* spectrogram: periodic-Hann framing with reflect centre padding, rfft,
  |.|^2, the HTK mel filterbank (built in f64 on the host, used in f32),
  log(mel + 1e-6);
* encoder: a 1-channel ResNet-18 (BasicBlocks, frozen BN: the audio
  tower's :class:`FrozenBatchNorm`) and a linear head to the CLIP
  embedding; torchvision module names, so a ``resnet18`` state dict
  loads through :func:`port_wav2clip_state_dict`;
* scoring against text reuses the port's CLIP text tower.

Every forward runs under ``full_f32`` (no TF32 in the convolutions or
the mel product).  The rfft is cuFFT on the card and pocketfft on the
CPU: the two round differently, which the embedding carries at cosine
>= 0.9999.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from avlmaps_torch.models.audioclip.esresnet import FrozenBatchNorm
from avlmaps_torch.utils.device import full_f32, resolve_device, to_device


@dataclasses.dataclass(frozen=True)
class Wav2ClipConfig:
    sample_rate: int = 16000
    n_fft: int = 512
    hop_length: int = 160
    n_mels: int = 64
    embed_dim: int = 512
    width: int = 64
    layers: Tuple[int, ...] = (2, 2, 2, 2)

    @staticmethod
    def tiny() -> "Wav2ClipConfig":
        return Wav2ClipConfig(n_fft=128, hop_length=64, n_mels=16,
                              embed_dim=16, width=8)


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """HTK-scale triangular mel filterbank (torchaudio MelSpectrogram's
    defaults, which wav2clip's front end uses), (n_mels, n_fft//2+1)."""
    fmax = fmax or sr / 2.0
    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0, sr / 2.0, n_freqs)
    hz_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                    n_mels + 2))
    fb = np.zeros((n_mels, n_freqs), np.float64)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[m] = np.maximum(0.0, np.minimum(up, down))
    return fb.astype(np.float32)


def log_mel_spectrogram(audio: torch.Tensor, cfg: Wav2ClipConfig
                        ) -> torch.Tensor:
    """(B, T) waveform in [-1, 1] -> (B, n_mels, 1 + T // hop) log-mel
    power."""
    n, dev = cfg.n_fft, audio.device
    window = torch.from_numpy(np.hanning(n + 1)[:-1].astype(np.float32)
                              ).to(dev)
    mel = torch.from_numpy(mel_filterbank(cfg.sample_rate, n,
                                          cfg.n_mels)).to(dev)
    padded = F.pad(audio.float()[:, None], (n // 2, n // 2),
                   mode="reflect")[:, 0]
    frames = padded.unfold(-1, n, cfg.hop_length) * window  # (B, F, n_fft)
    power = torch.fft.rfft(frames, dim=-1).abs() ** 2
    with full_f32():
        mel_spec = torch.einsum("bfk,mk->bmf", power, mel)
    return torch.log(mel_spec + 1e-6)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, planes, 1, stride=stride, bias=False),
                FrozenBatchNorm(planes))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class Wav2Clip(nn.Module):
    """Log-mel ResNet-18 -> CLIP-space embedding, parameters on ``device``
    (``"meta"`` for shapes only)."""

    def __init__(self, cfg: Wav2ClipConfig,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        dev = device if str(device) == "meta" else resolve_device(device)
        with torch.device(dev):
            self.conv1 = nn.Conv2d(1, w, 7, stride=2, padding=3, bias=False)
            self.bn1 = FrozenBatchNorm(w)
            cin = w
            for stage, n_blocks in enumerate(cfg.layers):
                planes = w * 2 ** stage
                blocks = []
                for blk in range(n_blocks):
                    stride = 2 if stage > 0 and blk == 0 else 1
                    blocks.append(BasicBlock(cin, planes, stride))
                    cin = planes
                setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            self.fc = nn.Linear(cin, cfg.embed_dim)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """audio: (B, T) f32 in [-1, 1] -> (B, embed_dim)."""
        with full_f32():
            x = log_mel_spectrogram(audio, self.cfg)[:, None]
            x = F.relu(self.bn1(self.conv1(x)))
            x = F.max_pool2d(x, 3, stride=2, padding=1)
            for stage in range(len(self.cfg.layers)):
                x = getattr(self, f"layer{stage + 1}")(x)
            return self.fc(x.mean(dim=(2, 3)))


def _np(v) -> np.ndarray:
    return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                      else v, np.float32)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, np.float32, order="C"))


def port_wav2clip_state_dict(sd: Mapping[str, Any],
                             cfg: Wav2ClipConfig = Wav2ClipConfig()
                             ) -> Dict[str, torch.Tensor]:
    """A torchvision-layout ``resnet18`` state dict (optionally under an
    ``encoder.`` / ``model.`` prefix, as the wav2clip release wraps it)
    -> this package's state_dict (f32 CPU; ``num_batches_tracked``
    dropped).  Raises ``KeyError`` without ``conv1`` or the ``fc`` head."""
    for prefix in ("", "encoder.", "model."):
        if f"{prefix}conv1.weight" in sd:
            break
    else:
        raise KeyError("no resnet18 conv1.weight found in state dict")
    if f"{prefix}fc.weight" not in sd:
        raise KeyError("no fc head in state dict")
    out: Dict[str, torch.Tensor] = {}
    for name, meta in Wav2Clip(cfg, device="meta").state_dict().items():
        key = prefix + name
        if key in sd:
            out[name] = _tensor(_np(sd[key]))
        elif name == "fc.bias":
            out[name] = torch.zeros(tuple(meta.shape))
        else:
            raise KeyError(f"wav2clip state dict lacks {key}")
    return out


_RENAME = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
           "var": "running_var", "downsample_conv": "downsample.0",
           "downsample_bn": "downsample.1"}


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's Wav2Clip variables -> this package's state_dict:
    conv kernels (kh, kw, in, out) -> (out, in, kh, kw), Dense (in, out)
    -> Linear (out, in), ``layer<s>_<b>`` -> ``layer<s>.<b>``, BatchNorm
    ``scale``/``mean``/``var`` -> ``weight``/``running_mean``/
    ``running_var``."""
    params = tree["params"] if "params" in tree else tree
    out: Dict[str, torch.Tensor] = {}

    def walk(node, keys):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, keys + [str(k)])
            return
        arr = _np(node)
        if keys[-1] == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        path = [k.replace("_", ".") if k.startswith("layer") else
                _RENAME.get(k, k) for k in keys]
        out[".".join(path)] = _tensor(arr)

    walk(params, [])
    return out


def init_params(cfg: Wav2ClipConfig,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Seeded weights for ``cfg`` on the generator's device, with the JAX
    package's initialisers' scale: conv and Linear weights N(0,
    1/fan_in), biases and BN means 0, BN scales and variances 1."""
    dev = generator.device
    out: Dict[str, torch.Tensor] = {}
    for name, meta in Wav2Clip(cfg, device="meta").state_dict().items():
        shape = tuple(meta.shape)
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("bias", "running_mean"):
            out[name] = torch.zeros(shape, device=dev)
        elif len(shape) == 1:  # BN scales and variances
            out[name] = torch.ones(shape, device=dev)
        else:
            out[name] = torch.randn(shape, generator=generator, device=dev) \
                / math.sqrt(math.prod(shape[1:]))
    return out


class Wav2ClipEncoder:
    """Wav2CLIP on ``device`` (default ``"cuda"``; raises without a card)
    with AudioClipEncoder's surface, so the sound map can swap encoders
    (reference create_wav2clip_audio_map, audio_utils.py:695-714).

    ``params`` is a state_dict of :class:`Wav2Clip` (``params_from_flax``
    or ``port_wav2clip_state_dict``); ``params=None`` draws seeded random
    weights at ``cfg``'s width.  ``clip_encoder`` scores text (CLIP
    ViT-B/32 on the same device when None)."""

    def __init__(self, cfg: Optional[Wav2ClipConfig] = None, params=None,
                 seed: int = 0, clip_encoder=None,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg or Wav2ClipConfig()
        self.device = resolve_device(device)
        self.embed_dim = self.cfg.embed_dim
        self.clip_encoder = clip_encoder
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = init_params(self.cfg, gen)
        self.model = Wav2Clip(self.cfg, device=self.device)
        self.model.load_state_dict(params, strict=True)
        self.model.eval().requires_grad_(False)

    @torch.no_grad()
    def encode_device(self, batch: np.ndarray) -> torch.Tensor:
        """(B, T) clips in [-1, 1] -> (B, embed_dim) raw embeddings on the
        device."""
        return self.model(to_device(batch, self.device, torch.float32))

    def embed_audio_batch(self, clips: Sequence[np.ndarray],
                          batch_size: int = 8) -> np.ndarray:
        """L2-normalised embeddings of clips zero-padded to the longest;
        the last batch is filled up with copies of its last clip."""
        t = max(int(np.asarray(c).shape[-1]) for c in clips)
        batch = np.zeros((len(clips), t), np.float32)
        for i, c in enumerate(clips):
            c = np.asarray(c, np.float32)
            batch[i, :c.shape[-1]] = c
        out = np.zeros((len(clips), self.embed_dim), np.float32)
        for s in range(0, len(clips), batch_size):
            chunk = batch[s:s + batch_size]
            pad = batch_size - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.tile(chunk[-1:],
                                                       (pad, 1))])
            f = self.encode_device(chunk).cpu().numpy()
            f = f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True),
                               1e-8)
            out[s:s + batch_size] = f[:batch_size - pad]
        return out

    def _clip(self):
        if self.clip_encoder is None:
            from avlmaps_torch.models.clip import ClipEncoder

            self.clip_encoder = ClipEncoder("ViT-B/32", device=self.device)
        return self.clip_encoder

    def audio_text_scores(self, audio_features: np.ndarray,
                          text_categories) -> np.ndarray:
        """Audio features against CLIP text features (reference
        create_wav2clip_audio_text_scores, audio_utils.py:716-735)."""
        text_feats = self._clip().get_text_feats(list(text_categories))
        return np.asarray(audio_features, np.float32) @ \
            np.asarray(text_feats, np.float32).T

    # -- AudioClipEncoder's surface, so SoundMap can swap encoders --------

    def encode_audio_batch(self, clips: Sequence[np.ndarray],
                           batch_size: int = 8) -> np.ndarray:
        # the sound map passes int16-scaled waveforms; wav2clip takes [-1, 1]
        return self.embed_audio_batch(
            [np.asarray(c, np.float32) / 32768.0 for c in clips], batch_size)

    def encode_text(self, texts) -> np.ndarray:
        joined = [", ".join(t) if isinstance(t, (list, tuple)) else t
                  for t in texts]
        feats = np.asarray(self._clip().get_text_feats(joined), np.float32)
        return feats / np.maximum(
            np.linalg.norm(feats, axis=-1, keepdims=True), 1e-8)

    def audio_text_logits(self, audio_feats: np.ndarray,
                          text_feats: np.ndarray) -> np.ndarray:
        # wav2clip has no learned audio-text scale: raw cosines (the
        # reference's create_wav2clip_audio_text_scores is the bare matmul)
        return np.asarray(audio_feats, np.float32) @ \
            np.asarray(text_feats, np.float32).T
