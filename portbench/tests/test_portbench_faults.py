"""With the timed path broken underneath, a whole run (past the look for
a card, at tiny shapes on the CPU) reads ``correct`` false: a step that
returns its state unchanged, half of a batch left out, an answer altered
where it is produced.  The cells run on one card, so no exchange between
cards can be left out."""

import pytest
import torch

import portbench.run as R
from portbench.bench import registry
from conftest import SEED, tiny_cell

MAN = registry.manifest()


def run_tiny(name):
    wl, over = tiny_cell(name)
    return R.run_cell(wl, SEED, 0.3, False, "cpu", MAN, cfg_override=over,
                      t_start=R.time.perf_counter())


CELL = "lseg-vitl16.build.packed"


def test_step_returns_state_unchanged(monkeypatch):
    import avlmaps_torch.map.vlmap_builder as vb

    monkeypatch.setattr(vb, "fuse_points", lambda state, *a, **k: state)
    assert not run_tiny(CELL)["correct"]


def test_half_of_each_batch_left_out(monkeypatch):
    import avlmaps_torch.map.vlmap_builder as vb

    real = vb.fuse_points

    def half(state, vids, feats, rgbs, alphas, valid, **kw):
        valid = valid.clone()
        valid[valid.shape[0] // 2:] = False
        return real(state, vids, feats, rgbs, alphas, valid, **kw)

    monkeypatch.setattr(vb, "fuse_points", half)
    assert not run_tiny(CELL)["correct"]


def test_features_altered_where_exported(monkeypatch):
    import avlmaps_torch.map.vlmap_builder as vb

    real = vb.export_fusion_state

    def altered(*a, **k):
        feat, *rest = real(*a, **k)
        return (feat * 1.05, *rest)

    monkeypatch.setattr(vb, "export_fusion_state", altered)
    assert not run_tiny(CELL)["correct"]


def test_query_half_of_the_map_left_out(monkeypatch):
    import avlmaps_torch.ops.delivery as dl

    real = dl.score_argmax

    def half(feats, text, **kw):
        out = real(feats, text, **kw).clone()
        out[out.shape[0] // 2:] = 1  # never the query's
        return out

    monkeypatch.setattr(dl, "score_argmax", half)
    assert not run_tiny("lseg-vitl16.query.object")["correct"]


@pytest.mark.parametrize("head", ["heat", "goal_pos", "topk_vals"])
def test_query_answer_altered(head, monkeypatch):
    import avlmaps_torch.ops.delivery as dl

    real = dl._object_query_program

    def altered(*a, **k):
        out = real(*a, **k)
        if head == "goal_pos":  # the coldest voxel of the map
            out["goal_pos"] = a[2][torch.argmin(out["heat"])]
        else:
            out[head] = out[head] * 0.99
        return out

    monkeypatch.setattr(dl, "_object_query_program", altered)
    assert not run_tiny("lseg-vitl16.query.object")["correct"]


def test_area_half_of_each_batch_left_out(monkeypatch):
    from avlmaps_torch.models.clip.features import ClipEncoder

    real = ClipEncoder.get_imgs_feats_batch

    def half(self, imgs, batch_size=64):
        out = real(self, imgs, batch_size)
        out[len(imgs) // 2:] = 0.0
        return out

    monkeypatch.setattr(ClipEncoder, "get_imgs_feats_batch", half)
    assert not run_tiny("clip-vitl14.area.build")["correct"]


def test_area_features_altered(monkeypatch):
    from avlmaps_torch.models.clip.features import ClipEncoder

    real = ClipEncoder.get_imgs_feats_batch

    def altered(self, imgs, batch_size=64):
        out = real(self, imgs, batch_size)
        return out + 0.01 * out[::-1]

    monkeypatch.setattr(ClipEncoder, "get_imgs_feats_batch", altered)
    assert not run_tiny("clip-vitl14.area.build")["correct"]
