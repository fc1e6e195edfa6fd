"""High-level CLIP feature APIs: prompt templates, batched text and image
features, and map scoring.

Counterpart of ``avlmaps_tpu/models/clip/features.py`` (reference
avlmaps/utils/clip_utils.py: templates :10-74, get_text_feats :133-149,
get_text_feats_multiple_templates :152-159, get_lseg_score :196-242):
tokenisation on the host, the towers on ``device``, normalisation there
too.  Map scoring goes through K8 (``score_features``) and the fused
score + argmax through K7 (``score_argmax``).  Batches are not padded and
the template ensemble's text axis is not bucketed: those kept the number
of XLA compiles down and buy nothing in PyTorch.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from avlmaps_torch.models.clip.model import (CLIP_VARIANTS, IMAGE_MEAN,
                                             IMAGE_STD, Clip, ClipConfig,
                                             preprocess_images)
from avlmaps_torch.models.clip.port import init_params, load_clip_checkpoint
from avlmaps_torch.models.clip.tokenizer import (ClipTokenizer,
                                                 default_tokenizer)
from avlmaps_torch.ops.clip_resample import FramePreprocess
from avlmaps_torch.ops.similarity import score_argmax, score_features
from avlmaps_torch.utils.device import resolve_device, to_device

# The 64 prompt-ensembling templates published with OpenAI CLIP's prompt
# engineering notebook (the set the reference embeds at clip_utils.py:10-74).
# These are public prompt data, not code.
MULTIPLE_TEMPLATES = [
    "There is {} in the scene.",
    "There is the {} in the scene.",
    "a photo of {} in the scene.",
    "a photo of the {} in the scene.",
    "a photo of one {} in the scene.",
    "I took a picture of of {}.",
    "I took a picture of of my {}.",
    "I took a picture of of the {}.",
    "a photo of {}.",
    "a photo of my {}.",
    "a photo of the {}.",
    "a photo of one {}.",
    "a photo of many {}.",
    "a good photo of {}.",
    "a good photo of the {}.",
    "a bad photo of {}.",
    "a bad photo of the {}.",
    "a photo of a nice {}.",
    "a photo of the nice {}.",
    "a photo of a cool {}.",
    "a photo of the cool {}.",
    "a photo of a weird {}.",
    "a photo of the weird {}.",
    "a photo of a small {}.",
    "a photo of the small {}.",
    "a photo of a large {}.",
    "a photo of the large {}.",
    "a photo of a clean {}.",
    "a photo of the clean {}.",
    "a photo of a dirty {}.",
    "a photo of the dirty {}.",
    "a bright photo of {}.",
    "a bright photo of the {}.",
    "a dark photo of {}.",
    "a dark photo of the {}.",
    "a photo of a hard to see {}.",
    "a photo of the hard to see {}.",
    "a low resolution photo of {}.",
    "a low resolution photo of the {}.",
    "a cropped photo of {}.",
    "a cropped photo of the {}.",
    "a close-up photo of {}.",
    "a close-up photo of the {}.",
    "a jpeg corrupted photo of {}.",
    "a jpeg corrupted photo of the {}.",
    "a blurry photo of {}.",
    "a blurry photo of the {}.",
    "a pixelated photo of {}.",
    "a pixelated photo of the {}.",
    "a black and white photo of the {}.",
    "a black and white photo of {}.",
    "a plastic {}.",
    "the plastic {}.",
    "a toy {}.",
    "the toy {}.",
    "a plushie {}.",
    "the plushie {}.",
    "a cartoon {}.",
    "the cartoon {}.",
    "an embroidered {}.",
    "the embroidered {}.",
    "a painting of the {}.",
    "a painting of a {}.",
]


def _array_fingerprint(a: np.ndarray, samples: int = 1024) -> bytes:
    """Cheap content fingerprint: hash of ``samples`` evenly-spaced rows,
    O(samples * D) whatever N, so in-place mutation of a cached map is
    caught without reading the multi-GB array."""
    flat = a.reshape(-1, a.shape[-1]) if a.ndim > 1 else a.reshape(-1, 1)
    idx = np.linspace(0, flat.shape[0] - 1, min(samples, flat.shape[0]),
                      dtype=np.int64)
    return hashlib.blake2b(np.ascontiguousarray(flat[idx]).tobytes(),
                           digest_size=16).digest()


def _with_other(landmarks: Sequence[str], add_other: bool) -> List[str]:
    out = list(landmarks)
    if add_other and out[-1] != "other":
        out.append("other")
    return out


class ClipEncoder:
    """CLIP config, weights on ``device`` and the feature APIs.

    ``params`` is a state_dict of this package's :class:`Clip` (e.g. from
    ``port.params_from_flax`` or ``port.load_clip_checkpoint``);
    ``params=None`` draws seeded random weights at the variant's full
    width (no CLIP checkpoint is part of the repository).  Runs on
    ``device`` (default ``"cuda"``; raises without a card).
    """

    def __init__(self, variant: str = "ViT-B/32", params=None,
                 tokenizer: Optional[ClipTokenizer] = None, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        self._setup(CLIP_VARIANTS[variant], variant, params, tokenizer, seed,
                    device)

    @classmethod
    def from_config(cls, cfg: ClipConfig, seed: int = 0,
                    tokenizer: Optional[ClipTokenizer] = None, params=None,
                    device: Union[str, torch.device] = "cuda"
                    ) -> "ClipEncoder":
        """Build from an explicit config (tests, custom sizes)."""
        enc = cls.__new__(cls)
        enc._setup(cfg, "custom", params, tokenizer, seed, device)
        return enc

    @classmethod
    def from_checkpoint(cls, path: str,
                        tokenizer: Optional[ClipTokenizer] = None,
                        device: Union[str, torch.device] = "cuda"
                        ) -> "ClipEncoder":
        """Load an OpenAI CLIP ``.pt`` or a pre-ported ``.msgpack`` (with
        its ``.config.json`` sidecar)."""
        cfg, params = load_clip_checkpoint(path)
        enc = cls.__new__(cls)
        enc._setup(cfg, "checkpoint", params, tokenizer, 0, device)
        return enc

    def _setup(self, cfg, variant, params, tokenizer, seed, device):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.variant = variant
        self.feat_dim = cfg.embed_dim
        self.tokenizer = tokenizer or default_tokenizer()
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = init_params(cfg, gen)
        self.model = Clip(cfg, device=self.device)
        self.model.load_state_dict(params, strict=True)
        self.model.eval().requires_grad_(False)
        self._map_dev = None
        self._map_dev_key = None
        self._frames = FramePreprocess(cfg.image_size, IMAGE_MEAN, IMAGE_STD,
                                       self.device)

    # -- text --------------------------------------------------------------

    def device_tokens(self, texts: Sequence[str]) -> torch.Tensor:
        """Token ids of ``texts`` on the device, cut after the last EOT of
        the batch (the zero padding behind it cannot reach an EOT row
        through the causal mask, so the features are the full context's)
        and staged through pinned memory so the upload does not make the
        host wait for the card."""
        ids = self.tokenizer(list(texts), self.cfg.context_length)
        width = int(ids.argmax(axis=1).max()) + 1 if len(ids) else 1
        return to_device(ids[:, :width], self.device, non_blocking=True)

    def _empty(self, as_device: bool):
        empty = torch.zeros((0, self.feat_dim), device=self.device)
        return empty if as_device else empty.cpu().numpy()

    @torch.no_grad()
    def get_text_feats(self, texts: Sequence[str], batch_size: int = 64,
                       as_device: bool = False):
        """L2-normalised text features, (len(texts), embed_dim) f32
        (reference get_text_feats, clip_utils.py:133-149): host numpy, or
        a tensor on the device with ``as_device=True``."""
        if not len(texts):
            return self._empty(as_device)
        chunks = []
        for start in range(0, len(texts), batch_size):
            feats = self.model.encode_text(
                self.device_tokens(texts[start:start + batch_size])).float()
            chunks.append(feats / torch.linalg.vector_norm(
                feats, dim=-1, keepdim=True))
        dev = torch.cat(chunks) if len(chunks) > 1 else chunks[0]
        return dev if as_device else dev.cpu().numpy()

    @torch.no_grad()
    def encode_templates(self, tokens: torch.Tensor) -> torch.Tensor:
        """The template ensemble on the device: ``tokens`` are the ids of
        ``len(MULTIPLE_TEMPLATES)`` prompts per text, text-major; encode
        all in one forward, L2-normalise, mean per text -> (n, embed_dim).
        """
        feats = self.model.encode_text(tokens).float()
        feats = feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
        return feats.reshape(-1, len(MULTIPLE_TEMPLATES),
                             feats.shape[-1]).mean(dim=1)

    def get_text_feats_multiple_templates(self, texts: Sequence[str],
                                          as_device: bool = False):
        """Template-ensembled text features (reference
        clip_utils.py:152-159): every (template, text) prompt encoded in
        one forward, normalised, averaged per text."""
        if not len(texts):
            return self._empty(as_device)
        prompts = [t.format(x) for x in texts for t in MULTIPLE_TEMPLATES]
        dev = self.encode_templates(self.device_tokens(prompts))
        return dev if as_device else dev.cpu().numpy()

    # -- image -------------------------------------------------------------

    def get_img_feats(self, img: np.ndarray) -> np.ndarray:
        """L2-normalised image features for one HWC uint8 image
        (reference get_img_feats, clip_utils.py:96-103)."""
        return self.get_imgs_feats_batch([img], batch_size=1)

    @torch.no_grad()
    def get_imgs_feats_batch(self, imgs: Sequence[np.ndarray],
                             batch_size: int = 64) -> np.ndarray:
        """Batched image features (reference clip_utils.py:113-130).

        On a CUDA device the frames go to the card as uint8 and one kernel
        a frame shape resizes, crops and normalises them there
        (``ops/clip_resample.py``); on the CPU :func:`preprocess_images`
        does it with PIL.  The two agree byte for byte, so the tower sees
        the same input either way."""
        out = np.zeros((len(imgs), self.feat_dim), np.float32)
        for start in range(0, len(imgs), batch_size):
            chunk = imgs[start:start + batch_size]
            with torch.profiler.record_function("clip.preprocess"):
                if self.device.type == "cuda":
                    batch = self._frames(chunk)
                else:
                    batch = to_device(preprocess_images(
                        chunk, self.cfg.image_size), self.device)
            feats = self.model.encode_image(batch).float().cpu().numpy()
            feats = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
            out[start:start + feats.shape[0]] = feats
        return out

    # -- scoring -----------------------------------------------------------

    def _landmark_feats(self, landmarks: List[str],
                        use_multiple_templates: bool, avg_mode: int):
        if use_multiple_templates and avg_mode == 0:
            return self.get_text_feats_multiple_templates(landmarks,
                                                          as_device=True)
        if use_multiple_templates:
            return self.get_text_feats(
                [t.format(x) for x in landmarks
                 for t in MULTIPLE_TEMPLATES], as_device=True)
        return self.get_text_feats(landmarks, as_device=True)

    def get_lseg_score(self, landmarks: List[str], map_feats: np.ndarray,
                       use_multiple_templates: bool = False,
                       avg_mode: int = 0, add_other: bool = True
                       ) -> np.ndarray:
        """Score map features against landmark texts with K8 (reference
        get_lseg_score, clip_utils.py:196-242) -> (N, C) host f32."""
        landmarks_other = _with_other(landmarks, add_other)
        text_feats = self._landmark_feats(landmarks_other,
                                          use_multiple_templates, avg_mode)
        scores = score_features(self._map_feats_device(map_feats),
                                text_feats).cpu().numpy()
        if use_multiple_templates and avg_mode == 1:
            scores = scores.reshape(-1, len(landmarks_other),
                                    len(MULTIPLE_TEMPLATES)).mean(axis=2)
        return scores

    def _map_feats_device(self, map_feats: np.ndarray) -> torch.Tensor:
        """Device copy of the flattened map features, cached across
        queries: repeated index queries over one map must not upload the
        multi-GB (N, D) matrix each time.

        The cache key is (object id, shape, content fingerprint): 1024
        evenly spaced rows are hashed, so in-place mutation of the same
        array re-uploads.  The fingerprint is SAMPLED -- a mutation confined
        to unsampled rows evades it; after partial in-place edits call
        :meth:`drop_map_cache` (which also frees the device copy)."""
        key = (id(map_feats), map_feats.shape,
               _array_fingerprint(map_feats))
        if self._map_dev_key != key:
            self._map_dev = None  # free the old copy before the upload
            flat = map_feats.reshape(-1, map_feats.shape[-1])
            self._map_dev = to_device(np.asarray(flat, np.float32),
                                      self.device)
            self._map_dev_key = key
        return self._map_dev

    def drop_map_cache(self) -> None:
        """Release the cached device copy of the last-queried map."""
        self._map_dev = None
        self._map_dev_key = None

    def get_lseg_argmax(self, landmarks: List[str], map_feats: np.ndarray,
                        use_multiple_templates: bool = False,
                        avg_mode: int = 0, add_other: bool = True
                        ) -> np.ndarray:
        """Per-voxel best-landmark index, (N,) int32, with K7: the fused
        form of the reference's score-then-np.argmax (clip_utils.py:196-242
        + vlmap.py:123-125); only N int32 come back to the host."""
        if use_multiple_templates and avg_mode == 1:
            # template-averaged scores cannot fuse
            scores = self.get_lseg_score(landmarks, map_feats,
                                         use_multiple_templates, avg_mode,
                                         add_other)
            return np.argmax(scores, axis=1).astype(np.int32)
        landmarks_other = _with_other(landmarks, add_other)
        text_feats = self._landmark_feats(landmarks_other,
                                          use_multiple_templates, avg_mode)
        return score_argmax(self._map_feats_device(map_feats),
                            text_feats).cpu().numpy()
