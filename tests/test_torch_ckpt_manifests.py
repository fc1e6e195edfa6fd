"""The port's checkpoint loaders held to the release artifacts' manifests.

Counterpart of ``tests/test_port_manifests.py``, case by case, for
``avlmaps_torch.tools.ckpt_manifest`` and ``avlmaps_torch.tools.
port_checkpoints``: every manifest in ``tools/ckpt_manifests/`` is
well-formed and round-trips; the diff flags each kind of drift; for each
of the 8 artifacts, the port's loader on a manifest-shaped synthetic
state dict gives the JAX porter's tree (through the port's
``params_from_flax``) key for key and bit for bit, and that tree
strict-loads into the port's release-scale module built on the meta
device; the CLI diffs, picks the superglue variant, reports drift and
writes a ``.pt`` that drives the port's SuperPoint.

Each manifest is synthesised once (a module-scoped fixture shared by the
round trip and both porters); the loaders read it through their own
``torch.load`` calls, handed the synthetic tensors without a copy, so at
most one synthetic LSeg and its two ported trees are alive at once.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from avlmaps_torch.tools import ckpt_manifest as cm
from avlmaps_torch.tools import port_checkpoints as pc

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import ckpt_manifest as jcm  # noqa: E402  (the JAX side's copy)

# the JAX tests' seeds, one a manifest
SEEDS = {"lseg_demo_e200": 2, "clip_vitb32": 3, "audioclip_partial": 4,
         "superpoint_v1": 5, "superglue_indoor": 6, "superglue_outdoor": 6,
         "netvlad_pitts30k": 8, "wav2clip_resnet18": 9}
ALL_MANIFESTS = list(SEEDS)


@dataclasses.dataclass
class Synthetic:
    name: str
    manifest: dict
    sd: dict
    path: Path  # the artifact file the port's loader opens


@pytest.fixture(scope="module", params=ALL_MANIFESTS)
def synthetic(request, tmp_path_factory):
    name = request.param
    manifest = cm.load_manifest(name)
    sd = cm.synthesize_state_dict(manifest, seed=SEEDS[name])
    path = tmp_path_factory.mktemp(name) / f"{name}.pth"
    if name == "netvlad_pitts30k":
        from scipy.io import savemat

        path = path.with_name("Pitts30K_struct.mat")
        savemat(str(path), cm.assemble_netvlad_mat(sd))
    else:
        # the loaders' torch.load is handed the tensors (see _loaded_as);
        # the file is what CLIP's jit probe opens first
        torch.save({}, path)
    yield Synthetic(name, manifest, sd, path)
    path.unlink()


def _tensors(sd):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def _loaded_as(monkeypatch, sd):
    """``torch.load`` returns ``sd`` as tensors sharing its memory: the
    loader's own read of a checkpoint whose state dict is ``sd``."""
    tensors = _tensors(sd)
    monkeypatch.setattr(torch, "load", lambda *a, **k: tensors)


def _assert_same_tree(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), k


def test_manifest_wellformed_and_roundtrips(synthetic):
    m = synthetic.manifest
    assert m["artifact"] and m["source"] and m["keys"]
    for spec in m["keys"].values():
        cm.parse_spec(spec)  # raises on malformed entries
    clean = {"missing": [], "unexpected": [], "mismatched": []}
    assert cm.diff_state_dict(synthetic.sd, m) == clean
    # optional keys omitted must still be clean
    required = {k: v for k, v in synthetic.sd.items()
                if not cm.parse_spec(m["keys"][k])[2]}
    assert cm.diff_state_dict(required, m) == clean


def test_synthesis_draws_as_the_jax_tool():
    m = cm.load_manifest("superpoint_v1")
    got = cm.synthesize_state_dict(m, seed=5)
    want = jcm.synthesize_state_dict(jcm.load_manifest("superpoint_v1"),
                                     seed=5)
    assert list(got) == list(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    assert cm.MANIFEST_DIR == jcm.MANIFEST_DIR


def test_diff_flags_every_drift_kind():
    m = cm.load_manifest("superpoint_v1")
    sd = cm.synthesize_state_dict(m)
    required = next(k for k, s in m["keys"].items()
                    if not cm.parse_spec(s)[2])
    del sd[required]
    sd["stray.key"] = np.zeros((3,), np.float32)
    reshaped = next(k for k in sd if k != "stray.key")
    sd[reshaped] = np.zeros((1, 2, 3), np.float32)
    diff = cm.diff_state_dict(sd, m)
    assert diff["missing"] == [required]
    assert diff["unexpected"] == ["stray.key"]
    assert [k for k, _, _ in diff["mismatched"]] == [reshaped]
    assert cm.diff_state_dict(_tensors(sd), m) == diff
    assert f"missing: {required}" in cm.format_diff(diff)


def _jax_tree(name, sd, path):
    """The JAX porter's tree for the artifact (its ``.mat`` reader for
    NetVLAD), through the port's ``params_from_flax``."""
    if name == "lseg_demo_e200":
        from avlmaps_tpu.models.lseg.port import port_lseg_state_dict
        from avlmaps_torch.models.lseg.port import params_from_flax

        return params_from_flax(port_lseg_state_dict(sd))
    if name == "clip_vitb32":
        from avlmaps_tpu.models.clip.port import port_clip_state_dict
        from avlmaps_torch.models.clip.port import params_from_flax

        return params_from_flax(port_clip_state_dict(sd))
    if name == "audioclip_partial":
        from avlmaps_tpu.models.audioclip.port import (
            config_from_state_dict, port_audioclip_state_dict)
        from avlmaps_torch.models.audioclip.port import params_from_flax

        return params_from_flax(port_audioclip_state_dict(
            sd, config_from_state_dict(sd)))
    if name == "superpoint_v1":
        from avlmaps_tpu.models.superpoint.port import (
            port_superpoint_state_dict)
        from avlmaps_torch.models.superpoint.port import params_from_flax

        return params_from_flax(port_superpoint_state_dict(sd))
    if name.startswith("superglue"):
        from avlmaps_tpu.models.superglue.port import (
            port_superglue_state_dict)
        from avlmaps_torch.models.superglue.port import params_from_flax

        return params_from_flax(port_superglue_state_dict(sd))
    if name == "netvlad_pitts30k":
        from avlmaps_tpu.models.netvlad.port import load_netvlad_mat
        from avlmaps_torch.models.netvlad.port import params_from_flax

        return params_from_flax(load_netvlad_mat(str(path))[0])
    from avlmaps_tpu.models.wav2clip import (Wav2ClipConfig,
                                             port_wav2clip_state_dict)
    from avlmaps_torch.models.wav2clip import params_from_flax

    return params_from_flax(port_wav2clip_state_dict(sd, Wav2ClipConfig()))


FLAG = {"lseg_demo_e200": "lseg", "clip_vitb32": "clip",
        "audioclip_partial": "audioclip", "superpoint_v1": "superpoint",
        "superglue_indoor": "superglue", "superglue_outdoor": "superglue",
        "netvlad_pitts30k": "netvlad", "wav2clip_resnet18": "wav2clip"}


def test_port_loader_equals_jax_porter_and_loads_release_module(
        synthetic, monkeypatch):
    """The port's loader on the manifest-shaped file gives the JAX
    porter's tree bit for bit, and the tree strict-loads into the port's
    release-scale module (meta device: no allocation)."""
    name, sd, path = synthetic.name, synthetic.sd, synthetic.path
    want = _jax_tree(name, sd, path)
    _loaded_as(monkeypatch, sd)
    ported = pc.port_artifact(FLAG[name], str(path))
    monkeypatch.undo()
    _assert_same_tree(ported.params, want)
    del want
    module = pc.strict_load(ported, "meta")
    assert set(module.state_dict()) == set(ported.params)
    assert ported.name == {"superglue_outdoor": "superglue_outdoor",
                           "superglue_indoor": "superglue"}.get(
        name, FLAG[name])
    if name == "clip_vitb32":
        from avlmaps_tpu.models.clip.port import (config_from_state_dict,
                                                  config_to_jsonable)

        assert ported.config == config_to_jsonable(
            config_from_state_dict(sd))
    if name == "netvlad_pitts30k":
        avg = sd["meta.normalization.averageImage"].reshape(-1, 3)
        np.testing.assert_allclose(ported.config["average_image"],
                                   avg.mean(axis=0), rtol=1e-6)
        assert (ported.config["clusters"], ported.config["dim"],
                ported.config["whiten_dim"]) == (64, 512, 4096)
        # the file stores negated centres; the loader recovers them
        raw = sd["layers.13_vlad:core.weights.1"]  # (D, K)
        assert torch.equal(ported.params["centers"],
                           torch.from_numpy(np.ascontiguousarray(-raw.T)))


def test_lseg_module_takes_the_release_layout():
    """The LSeg manifest's ViT depth and widths are the port's vitl16."""
    from avlmaps_torch.models.lseg import LSegConfig

    keys = cm.load_manifest("lseg_demo_e200")["keys"]
    blocks = {k.split(".")[4] for k in keys
              if k.startswith("net.pretrained.model.blocks.")}
    cfg = LSegConfig.vitl16()
    assert len(blocks) == cfg.vit.layers == 24
    assert cm.parse_spec(keys["net.pretrained.model.cls_token"])[0] == (
        1, 1, cfg.vit.width)


def _write_netvlad_mat(tmp_path, seed=10):
    from scipy.io import savemat

    sd = cm.synthesize_state_dict(cm.load_manifest("netvlad_pitts30k"),
                                  seed=seed)
    path = tmp_path / "Pitts30K_struct.mat"
    savemat(str(path), cm.assemble_netvlad_mat(sd))
    return path


def test_port_cli_netvlad_manifest_diff(tmp_path, capsys):
    """The CLI's NetVLAD diff runs through the .mat flattener and reports
    a clean file as clean."""
    path = _write_netvlad_mat(tmp_path)
    pc.check_against_manifest("netvlad", str(path), strict=True)
    assert "OK (matches manifest)" in capsys.readouterr().out


def test_manifest_name_picks_superglue_variant():
    assert pc._manifest_name("superglue", "x/superglue_indoor.pth") == \
        "superglue_indoor"
    assert pc._manifest_name("superglue", "x/superglue_outdoor.pth") == \
        "superglue_outdoor"
    assert pc._manifest_name("netvlad", "Pitts30K_struct.mat") == \
        "netvlad_pitts30k"
    assert pc._manifest_name("wav2clip", "Wav2CLIP.pt") == \
        "wav2clip_resnet18"


def _superpoint_file(tmp_path, seed=7):
    m = cm.load_manifest("superpoint_v1")
    sd = _tensors(cm.synthesize_state_dict(m, seed=seed))
    path = tmp_path / "superpoint_v1.pth"
    torch.save(sd, path)
    return path, sd


def test_port_cli_manifest_check_reports_drift(tmp_path, capsys):
    path, sd = _superpoint_file(tmp_path)
    pc.check_against_manifest("superpoint", str(path), strict=True)
    assert "OK (matches manifest)" in capsys.readouterr().out

    del sd["convPb.bias"]
    torch.save(sd, path)
    pc.check_against_manifest("superpoint", str(path), strict=False)
    assert "missing: convPb.bias" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        pc.check_against_manifest("superpoint", str(path), strict=True)
    with pytest.raises(SystemExit):
        pc.main(["--superpoint", str(path), "--strict-manifest",
                 "--device", "cpu", "--out", str(tmp_path / "out")])


def test_port_cli_superpoint_pt_drives_the_extractor(tmp_path):
    """``--out`` writes ``superpoint.pt``, the state dict the extractor
    takes as ``params=``: the same keypoints as the loader's params."""
    from avlmaps_torch.models.superpoint import (SuperPointExtractor,
                                                 load_superpoint_checkpoint)

    path, _ = _superpoint_file(tmp_path)
    out = tmp_path / "ported"
    done = pc.main(["--superpoint", str(path), "--out", str(out),
                    "--strict-manifest", "--device", "cpu"])
    assert done["superpoint"]["pt"] == out / "superpoint.pt"
    params = torch.load(out / "superpoint.pt")
    _, want_params = load_superpoint_checkpoint(str(path))
    _assert_same_tree(params, want_params)
    img = np.random.default_rng(0).uniform(0, 1, (1, 48, 64)).astype(
        np.float32)
    got = SuperPointExtractor(params=params, device="cpu").extract(img)
    want = SuperPointExtractor(params=want_params, device="cpu").extract(img)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def test_port_cli_records_manifests(tmp_path, monkeypatch):
    """``--record-manifests`` pins the manifest from the real file; the
    file then diffs clean against it."""
    path, _ = _superpoint_file(tmp_path)
    monkeypatch.setattr(pc, "MANIFEST_DIR", tmp_path / "manifests")
    pc.main(["--superpoint", str(path), "--record-manifests"])
    pinned = cm.load_manifest(tmp_path / "manifests" / "superpoint_v1.json")
    assert pinned["artifact"] == "superpoint_v1.pth"
    assert cm.diff_state_dict(torch.load(path), pinned) == {
        "missing": [], "unexpected": [], "mismatched": []}
    assert set(pinned["keys"]) == {
        k for k, s in cm.load_manifest("superpoint_v1")["keys"].items()}
