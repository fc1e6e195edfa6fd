"""The operation and byte counts against hand counts."""

from portbench.bench import registry, roofline

LSEG = registry.config("lseg-vitl16")
CLIP = registry.config("clip-vitl14")


def test_vit_l16_crop_by_hand():
    # 480^2 crop: 900 patches + cls = 901 tokens, width 1024, 24 blocks
    t, w = 901, 1024
    blocks = 24 * (2 * 12 * w * w * t + 4 * t * t * w)
    patch = 2 * 900 * (16 * 16 * 3) * w
    assert LSEG["module"].vit_crop_flops(LSEG) == blocks + patch
    assert abs(blocks - 623.9e9) / 623.9e9 < 1e-3


def test_vit_l16_bytes_by_hand():
    # bf16 block weights once a forward of 16 crops, then per crop its
    # f32 image and four bf16 taps
    w = 1024
    weights = 24 * 12 * w * w * 2
    io = 480 * 480 * 3 * 4 + 4 * 901 * w * 2
    assert LSEG["module"].vit_crop_bytes(LSEG, 16) == weights / 16 + io


def test_frame_counts_two_crops():
    m = LSEG["module"]
    assert m.crops_per_frame(LSEG) == 2
    assert m.frame_flops(LSEG) == 2 * (m.vit_crop_flops(LSEG)
                                       + m.decoder_crop_flops(LSEG))


def test_dpt_head_by_hand():
    # a 2x2 token grid, width 4, reassemble (1, 2, 4, 4), 2 features,
    # 3 output channels, written out layer by layer
    g, w, f, o = 2, 4, 2, 3
    ch = (1, 2, 4, 4)
    sizes = (8, 4, 2, 1)
    total = 0
    for lvl in range(4):
        total += 2 * 4 * w * w + 2 * w * w  # readout: tokens, cls
        total += 2 * 4 * w * ch[lvl]  # 1x1 projection at 2x2
    total += 2 * 4 * 1 * 1 * 16  # 4x4 stride-4 transposed conv
    total += 2 * 4 * 2 * 2 * 4  # 2x2 stride-2 transposed conv
    total += 2 * 1 * 4 * 4 * 9  # 3x3 stride-2 conv to 1x1
    total += sum(2 * s * s * c * f * 9 for s, c in zip(sizes, ch))
    rcu = 2 * (2 * f * f * 9)
    total += rcu * 1 + 2 * 2 * 2 * f * f  # refinenet 4 (1x1), out at 2x2
    total += 2 * rcu * 4 + 2 * 16 * f * f  # at 2x2, out at 4x4
    total += 2 * rcu * 16 + 2 * 64 * f * f  # at 4x4, out at 8x8
    total += 2 * rcu * 64 + 2 * 256 * f * f  # at 8x8, out at 16x16
    total += 2 * 256 * f * o  # head at 16x16
    assert roofline.dpt_head_flops(g, w, ch, f, o) == total


def test_clip_l14_image_by_hand():
    t, w = 257, 1024
    blocks = 24 * (2 * 12 * w * w * t + 4 * t * t * w)
    patch = 2 * 256 * (14 * 14 * 3) * w
    proj = 2 * w * 768
    assert CLIP["module"].image_flops(CLIP) == blocks + patch + proj


def test_least_seconds_picks_the_bound():
    assert roofline.least_seconds(989e12, 0, "bfloat16") == 1.0
    assert roofline.least_seconds(0, 3.35e12, "bfloat16") == 1.0
    assert roofline.least_seconds(67e12, 0, "float32") == 1.0
