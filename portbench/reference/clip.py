"""CLIP (Radford et al. 2021; github.com/openai/CLIP) as plain functions
of a state dict with the benchmark's key layout (``text.*``,
``visual.*``): the byte-level tokenizer, the text tower and the image
tower with its preprocessing.

Tokenizer: OpenAI's ``simple_tokenizer`` scheme (the GPT-2 byte table,
word-final bytes as ``</w>`` tokens, start 49406, end 49407, 77
positions, zero padding) without its merges file, which no checkpoint in
the repository carries: every word is spelled in byte tokens.  Text
cleaning: HTML entities unescaped twice, whitespace collapsed,
lower-cased (``ftfy`` is not used).

Towers: pre-LN residual blocks with QuickGELU and LayerNorm eps 1e-5; the
text tower reads the end token's position under a causal mask and
projects; the image tower embeds 14x14 or 32x32 patches (a convolution
without bias), adds the class token and positions, applies ``ln_pre``,
and projects the class token after ``ln_post``.
"""

from __future__ import annotations

import html
import math
import re
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.precision import Precision

SOT, EOT, CONTEXT = 49406, 49407, 77
_PAT = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
                  r"|[^\W\d_]+|\d|[^\s\w]+", re.IGNORECASE | re.UNICODE)


def _byte_ids() -> Dict[int, int]:
    """Token id of each byte: its place in the GPT-2 byte table (the
    printable bytes first, then the rest in byte order)."""
    printable = (list(range(ord("!"), ord("~") + 1))
                 + list(range(ord("\xa1"), ord("\xac") + 1))
                 + list(range(ord("\xae"), ord("\xff") + 1)))
    order = printable + [b for b in range(256) if b not in printable]
    return {b: i for i, b in enumerate(order)}


_BYTE_ID = _byte_ids()


def tokenize(texts: Sequence[str]) -> np.ndarray:
    out = np.zeros((len(texts), CONTEXT), np.int64)
    for i, text in enumerate(texts):
        clean = re.sub(r"\s+", " ", html.unescape(html.unescape(text))) \
            .strip().lower()
        ids = [SOT]
        for word in _PAT.findall(clean):
            b = word.encode("utf-8")
            ids += [_BYTE_ID[c] for c in b[:-1]] + [256 + _BYTE_ID[b[-1]]]
        ids.append(EOT)
        if len(ids) > CONTEXT:
            ids = ids[:CONTEXT - 1] + [EOT]
        out[i, :len(ids)] = ids
    return out


def _block(sd, k: str, x, heads: int, p: Precision, mask=None):
    b, t, w = x.shape
    hd = w // heads
    y = F.layer_norm(x, (w,), sd[k + "ln_1.weight"], sd[k + "ln_1.bias"],
                     eps=1e-5)
    qkv = F.linear(p.q(y), p.q(sd[k + "attn.qkv.weight"]),
                   sd[k + "attn.qkv.bias"])
    q, kk, v = (z.reshape(b, t, heads, hd).transpose(1, 2)
                for z in qkv.split(w, dim=-1))
    a = p.q(q) @ p.q(kk).transpose(-1, -2) / math.sqrt(hd)
    if mask is not None:
        a = a + mask
    y = (p.q(torch.softmax(a, -1)) @ p.q(v)).transpose(1, 2).reshape(b, t, w)
    x = x + F.linear(p.q(y), p.q(sd[k + "attn.out.weight"]),
                     sd[k + "attn.out.bias"])
    y = F.layer_norm(x, (w,), sd[k + "ln_2.weight"], sd[k + "ln_2.bias"],
                     eps=1e-5)
    y = F.linear(p.q(y), p.q(sd[k + "mlp_fc.weight"]), sd[k + "mlp_fc.bias"])
    y = y * torch.sigmoid(1.702 * y)
    return x + F.linear(p.q(y), p.q(sd[k + "mlp_proj.weight"]),
                        sd[k + "mlp_proj.bias"])


def _n_blocks(sd, prefix: str) -> int:
    return len({k.split(".")[2] for k in sd if k.startswith(prefix)})


def encode_text(sd: Dict[str, torch.Tensor], ids: np.ndarray, heads: int,
                p: Precision, chunk: int = 512) -> torch.Tensor:
    """(B, 77) ids -> (B, embed) f32, the projection at the end token."""
    dev = sd["text.token_embedding.weight"].device
    n_layers = _n_blocks(sd, "text.blocks.")
    out = []
    with p.products():
        for s in range(0, len(ids), chunk):
            part = torch.from_numpy(ids[s:s + chunk]).to(dev)
            t = int(part.argmax(1).max()) + 1
            part = part[:, :t]
            x = sd["text.token_embedding.weight"][part] \
                + sd["text.positional_embedding"][:t]
            mask = torch.full((t, t), float("-inf"), device=dev).triu_(1)
            for i in range(n_layers):
                x = _block(sd, f"text.blocks.{i}.", x, heads, p, mask)
            w = x.shape[-1]
            x = F.layer_norm(x, (w,), sd["text.ln_final.weight"],
                             sd["text.ln_final.bias"], eps=1e-5)
            x = x[torch.arange(x.shape[0], device=dev), part.argmax(1)]
            out.append(F.linear(p.q(x), p.q(sd["text.text_projection"].T)))
    return torch.cat(out)


def template_features(sd, words: Sequence[str], templates: Sequence[str],
                      heads: int, p: Precision) -> torch.Tensor:
    """Per word, the mean of its prompts' L2-normalised features
    (AVLMaps ``get_text_feats_multiple_templates``): (len(words), D)."""
    prompts = [t.format(w) for w in words for t in templates]
    f = encode_text(sd, tokenize(prompts), heads, p)
    f = f / f.norm(dim=-1, keepdim=True)
    return f.view(len(words), len(templates), -1).mean(1)


MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess(images_u8: Sequence[np.ndarray], size: int) -> np.ndarray:
    """CLIP's preprocessing: bicubic resize of the short side to
    ``size``, centre crop, scale to [0, 1], normalise: (B, size, size, 3)."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    def one(img):
        pil = Image.fromarray(np.uint8(img))
        w, h = pil.size
        s = size / min(w, h)
        pil = pil.resize((max(size, int(round(w * s))),
                          max(size, int(round(h * s)))), Image.BICUBIC)
        w, h = pil.size
        left, top = (w - size) // 2, (h - size) // 2
        pil = pil.crop((left, top, left + size, top + size))
        return np.asarray(pil, np.float32) / 255.0

    with ThreadPoolExecutor(8) as pool:
        out = np.stack(list(pool.map(one, images_u8)))
    return (out - MEAN) / STD


def encode_image(sd: Dict[str, torch.Tensor], images: torch.Tensor,
                 patch: int, p: Precision) -> torch.Tensor:
    """(B, H, W, 3) preprocessed -> (B, embed) f32."""
    w = sd["visual.class_embedding"].shape[0]
    heads = max(1, w // 64)
    kernel = sd["visual.patch_embed.weight"].view(w, patch, patch, 3) \
        .permute(0, 3, 1, 2)
    with p.products():
        x = F.conv2d(p.q(images.permute(0, 3, 1, 2)), p.q(kernel),
                     stride=patch)
        x = x.flatten(2).transpose(1, 2)
        cls = sd["visual.class_embedding"].expand(x.shape[0], 1, w)
        x = torch.cat([cls, x], 1) + sd["visual.positional_embedding"]
        x = F.layer_norm(x, (w,), sd["visual.ln_pre.weight"],
                         sd["visual.ln_pre.bias"], eps=1e-5)
        for i in range(_n_blocks(sd, "visual.blocks.")):
            x = _block(sd, f"visual.blocks.{i}.", x, heads, p)
        x = F.layer_norm(x[:, 0], (w,), sd["visual.ln_post.weight"],
                         sd["visual.ln_post.bias"], eps=1e-5)
        return F.linear(p.q(x), p.q(sd["visual.proj"].T))
