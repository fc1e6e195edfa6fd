"""How AudioCLIP's filterbank sums treat an event's zero padding.

    python3 probes/fbsp_silence.py [--device cpu|cuda]

An event's 5 s context is zero-padded, and ``scale_signal`` turns the
padding into a constant (~1.5e-5) that the FBSP filterbank nearly
cancels.  This builds the full-width audio tower (``AudioClipConfig()``,
seeded weights) and embeds two 220,500-sample clips -- a 1.5 s noise
event zero-padded to 5 s, and 5 s of noise -- with the filterbank summed
in f64 (the port's ``fbsp_apply``) and in f32 (a plain matmul, as the
JAX package sums), on the CPU and, with ``--device cuda``, on the card.
It prints the largest dB difference of the padded frames and the cosine
and max abs difference of the L2-normalised embeddings for each pair.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def f32_apply(frames, weights):
    import torch

    re = torch.matmul(frames, weights[..., 0].float().T)
    im = torch.matmul(frames, weights[..., 1].float().T)
    return torch.stack([re, im], dim=-1)


@contextlib.contextmanager
def f32_sums():
    from avlmaps_torch.models.audioclip import esresnet

    kept = esresnet.fbsp_apply
    esresnet.fbsp_apply = f32_apply
    try:
        yield
    finally:
        esresnet.fbsp_apply = kept


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = ap.parse_args()

    import torch

    from avlmaps_torch.models.audioclip import AudioClipEncoder

    cpu = AudioClipEncoder(seed=0, device="cpu")
    encoders = {"cpu": cpu}
    if args.device == "cuda":
        encoders["card"] = AudioClipEncoder(cpu.cfg, device="cuda", params={
            k: v for k, v in cpu.model.state_dict().items()})
    sr = 44100
    rng = np.random.default_rng(0)
    event = (rng.normal(size=int(1.5 * sr)) * 0.2 * 32768).astype(np.float32)
    padded = np.zeros(5 * sr, np.float32)
    padded[:event.size] = event
    full = (rng.normal(size=5 * sr) * 0.2 * 32768).astype(np.float32)
    clips = np.stack([padded, full])

    emb, specs = {}, {}
    with torch.no_grad():
        for where, enc in encoders.items():
            for sums in ("f64", "f32"):
                with f32_sums() if sums == "f32" else contextlib.nullcontext():
                    x = torch.from_numpy(clips).to(enc.device)
                    specs[where, sums] = enc.model.audio.spectrogram(
                        x).double().cpu()
                    emb[where, sums] = enc.encode_audio_device(
                        clips).double().cpu().numpy()
    tail = slice(300, None)  # frames past the 1.5 s event: padding
    base = specs["cpu", "f64"]
    for key, spec in specs.items():
        d = (spec - base).abs()
        print(f"spectrogram {key[0]} {key[1]} sums vs cpu f64: max |dB| "
              f"padded frames {float(d[0, :, :, tail].max()):.4f}, event "
              f"frames {float(d[0, :, :, :100].max()):.4f}, full clip "
              f"{float(d[1].max()):.4f}")
    keys = list(emb)
    for i, a in enumerate(keys):
        for b in keys[i + 1:]:
            ea = emb[a] / np.linalg.norm(emb[a], axis=1, keepdims=True)
            eb = emb[b] / np.linalg.norm(emb[b], axis=1, keepdims=True)
            cos = (ea * eb).sum(1)
            err = np.abs(ea - eb).max(1)
            print(f"{a[0]} {a[1]} vs {b[0]} {b[1]}: padded clip cosine "
                  f"{cos[0]:.7f} max |d| {err[0]:.2e}; full clip cosine "
                  f"{cos[1]:.7f} max |d| {err[1]:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
