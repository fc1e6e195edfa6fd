"""CLIP's image preprocess on the card (``ops/clip_resample.py``) against
PIL's (``models/clip/model.py::preprocess_images``).

The plain version, which the CPU runs, is held to PIL byte for byte: the
f32 outputs are compared with ``np.array_equal``, so one grey level off in
one pixel fails.  The tests marked ``cuda`` hold the kernel to the plain
version and to PIL at the area map's shape, (64, 720, 1080, 3), and show
that a CUDA encoder never calls PIL; they skip without a card.  They
import neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_clip_resample.py
"""

import sys
import threading

import numpy as np
import pytest
import torch

from avlmaps_torch.models.clip import ClipConfig, ClipEncoder
from avlmaps_torch.models.clip.model import (IMAGE_MEAN, IMAGE_STD,
                                             preprocess_images)
from avlmaps_torch.ops import clip_resample as cr

SIZE = 224
# downsampling and upsampling, both orientations, the 1-pixel extremes
SHAPES = [(720, 1080), (480, 640), (100, 300), (224, 224), (150, 120),
          (1, 1), (300, 7), (1, 57), (61, 1)]


def _frames(seed, n, shape):
    return np.random.default_rng(seed).integers(0, 256, (n,) + shape + (3,),
                                                dtype=np.uint8)


def _plain(frames):
    return cr.clip_resample(torch.from_numpy(np.ascontiguousarray(frames)),
                            SIZE, IMAGE_MEAN, IMAGE_STD).numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_version_matches_pil_byte_for_byte(shape):
    frames = _frames(sum(shape), 2, shape)
    got = _plain(frames)
    assert got.dtype == np.float32 and got.shape == (2, SIZE, SIZE, 3)
    assert np.array_equal(got, preprocess_images(frames, SIZE))


def test_coefficient_tables_match_a_hand_checked_case():
    """4 -> 2 pixels: scale 2, support 4, 9 taps a row.  Output 0 is
    centred at 1.0 and reads the cubic at -0.25, 0.25, 0.75, 1.25 (111,
    111, 29, -9 in 128ths, sum 242); output 1, at 3.0, the mirror image,
    and its first tap int(3 - 4 + 0.5) = int(-0.5) truncates to 0.  Each
    weight is w / 242 x 2^22 rounded half away from zero."""
    bounds, coeffs = cr.pil_coeffs(4, 2)
    assert bounds.tolist() == [[0, 4], [0, 4]]
    assert coeffs.tolist() == [
        [1923834, 1923834, 502623, -155987, 0, 0, 0, 0, 0],
        [-155987, 502623, 1923834, 1923834, 0, 0, 0, 0, 0]]
    assert (coeffs.sum(1) == 1 << cr.PRECISION_BITS).all()
    # the same size: weights (0, 1, 0, 0) copy each pixel
    bounds, coeffs = cr.pil_coeffs(3, 3)
    assert bounds.tolist() == [[0, 3], [0, 3], [1, 2]]
    assert coeffs[:, :3].tolist() == [[1 << 22, 0, 0], [0, 1 << 22, 0],
                                      [0, 1 << 22, 0]]


def test_crop_tables_cover_only_the_crop():
    t = cr.crop_tables(720, 1080, SIZE)  # resized to 224 x 336, cropped
    full_b, full_k = cr.pil_coeffs(1080, 336)
    np.testing.assert_array_equal(t.hb, full_b[56:280])
    np.testing.assert_array_equal(t.hk, full_k[56:280])
    assert t.vb.shape == (SIZE, 2) and t.hk.shape == (SIZE, 15)


# the input rows and columns under the crop's taps, (first, end) each; the
# area map's frame keeps columns 175..904: output column 56 of 336 centres
# on 56.5 x 1080 / 336 = 181.6 with support 6.43, so its first tap is
# int(181.6 - 6.43 + 0.5) = 175; output 279's last ends at 905
@pytest.mark.parametrize("shape, span", [
    ((720, 1080), ((0, 720), (175, 905))),
    ((1080, 720), ((175, 905), (0, 720)))], ids=["720x1080", "1080x720"])
def test_crop_reads_only_the_span_under_its_taps(shape, span):
    t = cr.crop_tables(*shape, SIZE)
    (y0, y1), (x0, x1) = span
    assert (t.vb[0, 0], t.vb[-1].sum()) == (y0, y1)
    assert (t.hb[0, 0], t.hb[-1].sum()) == (x0, x1)
    frame = _frames(7, 1, shape)
    outside = 255 - frame
    outside[:, y0:y1, x0:x1] = frame[:, y0:y1, x0:x1]
    assert np.array_equal(_plain(outside), _plain(frame))


def test_empty_frame_follows_the_host_rule():
    imgs = [np.zeros((0, 5, 3), np.uint8), _frames(1, 1, (40, 30))[0],
            np.zeros((7, 0, 3), np.uint8)]
    got = cr.FramePreprocess(SIZE, IMAGE_MEAN, IMAGE_STD, "cpu")(imgs)
    assert np.array_equal(got.numpy(), preprocess_images(imgs, SIZE))


def test_mixed_shape_batch_keeps_its_order():
    shapes = [(100, 300), (50, 60), (100, 300), (61, 1), (50, 60)]
    imgs = [_frames(i, 1, s)[0] for i, s in enumerate(shapes)]
    imgs[1] = imgs[1].astype(np.float32)  # cast to uint8, as on the host
    before = cr.clip_resample.launches
    pre = cr.FramePreprocess(SIZE, IMAGE_MEAN, IMAGE_STD, "cpu")
    got = pre(imgs).numpy()
    assert np.array_equal(got, preprocess_images(imgs, SIZE))
    assert cr.clip_resample.launches == before  # the CPU launches nothing
    # the staging buffer is reused and the next batch does not see this one
    assert np.array_equal(pre(imgs[3:]).numpy(),
                          preprocess_images(imgs[3:], SIZE))
    assert pre(()).shape == (0, SIZE, SIZE, 3)


def test_concurrent_calls_keep_their_own_frames():
    """Twelve threads share one preprocess and its staging buffer, with a
    short switch interval: each gets its own frames back."""
    pre = cr.FramePreprocess(SIZE, IMAGE_MEAN, IMAGE_STD, "cpu")
    batches = [_frames(i, 3, (40 + i, 60)) for i in range(12)]
    got = [None] * len(batches)

    def work(i):
        for _ in range(3):
            got[i] = pre(list(batches[i])).numpy()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(batches))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for frames, out in zip(batches, got):
        assert np.array_equal(out, preprocess_images(frames, SIZE))


@pytest.mark.parametrize("bad", [np.zeros((4, 4), np.uint8),
                                 np.zeros((4, 4, 4), np.uint8)])
def test_frames_must_be_rgb(bad):
    with pytest.raises(ValueError, match="HWC RGB"):
        cr.FramePreprocess(SIZE, IMAGE_MEAN, IMAGE_STD, "cpu")([bad])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_and_pil_at_the_area_map_shape(card):
    frames = _frames(19, 64, (720, 1080))
    before = cr.clip_resample.launches
    got = cr.clip_resample(torch.from_numpy(frames).to(card), SIZE,
                           IMAGE_MEAN, IMAGE_STD).cpu().numpy()
    assert cr.clip_resample.launches == before + 1
    assert np.array_equal(got, _plain(frames))
    assert np.array_equal(got, preprocess_images(frames, SIZE))


@pytest.mark.cuda
def test_kernel_matches_pil_on_every_shape_in_one_batch(card):
    """Frames of every shape through the pinned staging, one launch a
    shape: odd row lengths put each row's span at every 16-byte phase."""
    imgs = [_frames(i, 1, s)[0] for i, s in enumerate(SHAPES + [(333, 500)])]
    imgs += imgs[:3]
    before = cr.clip_resample.launches
    got = cr.FramePreprocess(SIZE, IMAGE_MEAN, IMAGE_STD, card)(imgs)
    assert cr.clip_resample.launches == before + len(SHAPES) + 1
    assert np.array_equal(got.cpu().numpy(), preprocess_images(imgs, SIZE))


@pytest.mark.cuda
def test_cuda_encoder_never_calls_pil(card, monkeypatch):
    enc = ClipEncoder.from_config(
        ClipConfig(embed_dim=24, image_size=SIZE, patch_size=32,
                   vision_width=64, vision_layers=2, text_width=32,
                   text_layers=1, text_heads=2), device=card)
    imgs = list(_frames(5, 130, (72, 108)))
    want = []
    for s in range(0, len(imgs), 64):
        f = enc.model.encode_image(torch.from_numpy(
            preprocess_images(imgs[s:s + 64], SIZE)).to(card)).float()
        f = f.cpu().numpy()
        want.append(f / np.linalg.norm(f, axis=-1, keepdims=True))

    def refuse(*a, **k):
        raise AssertionError("PIL resize on the CUDA path")

    from PIL import Image
    monkeypatch.setattr(Image.Image, "resize", refuse)
    before = cr.clip_resample.launches
    got = enc.get_imgs_feats_batch(imgs, batch_size=64)
    assert cr.clip_resample.launches == before + 3
    np.testing.assert_array_equal(got, np.concatenate(want))
