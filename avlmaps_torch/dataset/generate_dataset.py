"""Dataset generation: render RGB-D-semantic sequences at recorded poses and
synthesise ESC-50-augmented audio tracks.

Counterpart of ``dataset/generate_dataset.py`` over the port's modules
(reference: dataset/generate_dataset.py + avlmaps/utils/audio_utils.py):

    python -m avlmaps_torch.dataset.generate_dataset --data-dir DIR \
        --esc50-meta esc50.csv --esc50-audio ESC-50/audio

Stage gating: scene rendering needs habitat-sim (skipped with a message when
absent); audio synthesis is ffmpeg-FREE here — sounds are mixed into a wav
directly with numpy (the reference shells out to ffmpeg amix/adelay,
audio_utils.py:125-227), and the per-sequence ``audio.wav`` output is
exactly what SoundMap consumes.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Tuple

import numpy as np

from avlmaps_torch.config import load_config
from avlmaps_torch.robot.sim import HABITAT_AVAILABLE
from avlmaps_torch.utils.audio import read_wav, write_wav
from avlmaps_torch.utils.esc50 import ESC50Meta


# ---------------------------------------------------------------------------
# stage 1: render frames at poses (habitat-gated)
# ---------------------------------------------------------------------------


def generate_scene_data(save_dir: Path, scene_path: Path, poses: np.ndarray,
                        data_cfg=None, camera_height: float = 1.5,
                        width: int = 640, height: int = 480) -> None:
    """Render the enabled sensors at each recorded pose
    (reference generate_scene_data, dataset/generate_dataset.py:42-96).

    ``data_cfg`` (config.DataCfg, reference config/generate_dataset.yaml's
    data_cfg group) selects sensors/resolution; the explicit kwargs remain
    as a config-free path."""
    if data_cfg is not None:
        camera_height = data_cfg.camera_height
        width, height = data_cfg.resolution.w, data_cfg.resolution.h
        want = {"rgb": data_cfg.rgb, "depth": data_cfg.depth,
                "semantic": data_cfg.semantic}
    else:
        want = {"rgb": True, "depth": True, "semantic": True}
    if not HABITAT_AVAILABLE:
        print("habitat-sim not installed: skipping scene rendering "
              f"for {scene_path}")
        return
    import cv2
    from avlmaps_torch.geometry.transforms import pose_vec_to_tf
    from avlmaps_torch.robot.sim import HabitatSimulator

    sim = HabitatSimulator(str(scene_path), {
        "sensor_height": camera_height, "width": width, "height": height,
        "color_sensor": want["rgb"], "depth_sensor": want["depth"],
        "semantic_sensor": want["semantic"],
    })
    for name, on in want.items():
        if on:
            (save_dir / name).mkdir(parents=True, exist_ok=True)
    for i, pose in enumerate(poses):
        out_rgb = save_dir / "rgb" / f"{i:06d}.png"
        if want["rgb"] and out_rgb.exists():
            continue
        sim.set_agent_tf(pose_vec_to_tf(pose))
        obs = sim.get_observation()
        if want["rgb"] and "color_sensor" in obs:
            cv2.imwrite(str(out_rgb), obs["color_sensor"][:, :, [2, 1, 0]])
        if want["depth"] and "depth_sensor" in obs:
            np.save(save_dir / "depth" / f"{i:06d}.npy", obs["depth_sensor"])
        if want["semantic"] and "semantic_sensor" in obs:
            np.save(save_dir / "semantic" / f"{i:06d}.npy",
                    obs["semantic_sensor"])
    sim.close()


# ---------------------------------------------------------------------------
# stage 0: dataset fetch (network-gated, like ffmpeg/habitat)
# ---------------------------------------------------------------------------

# pose/audio-video metadata archive the reference pulls with gdown
# (reference dataset/generate_dataset.py:109-116)
DATASET_GDRIVE_URL = ("https://drive.google.com/file/d/"
                      "1Vrxpk2XFnk2WbJrnLNCyGgJ141JPoDDj/view?usp=sharing")


def fetch_dataset(data_dir: Path) -> Path:
    """Download + unzip the avlmaps pose/audio-video metadata archive if the
    dataset directory is absent (reference main, generate_dataset.py:107-116).

    Gated on gdown being importable (like the ffmpeg/habitat gates): offline
    environments get a clear instruction instead of a crash."""
    data_dir = Path(data_dir)
    dataset_dir = data_dir / "avlmaps_dataset"
    if dataset_dir.exists():
        return dataset_dir
    try:
        import gdown  # noqa: F401
    except ImportError:
        raise RuntimeError(
            f"{dataset_dir} is missing and gdown is not installed; download "
            f"the archive manually from {DATASET_GDRIVE_URL} and unzip it "
            f"into {data_dir}") from None
    import subprocess

    data_dir.mkdir(parents=True, exist_ok=True)
    zip_path = data_dir / "avlmaps_dataset.zip"
    gdown.download(DATASET_GDRIVE_URL, str(zip_path), fuzzy=True)
    subprocess.run(["unzip", str(zip_path), "-d", str(data_dir)], check=True)
    return dataset_dir


# ---------------------------------------------------------------------------
# stage 2: audio slot selection (pure geometry)
# ---------------------------------------------------------------------------


def select_audio_frames(poses: np.ndarray, avoid_pos: np.ndarray,
                        fps: float = 25, clip_s: float = 5.0,
                        min_dist: float = 2.0
                        ) -> Tuple[List[Tuple[int, int]], np.ndarray]:
    """Pick clip_s-long frame windows whose trajectory stays >= min_dist
    away from all previously-used sound positions (reference
    select_audio_frames, audio_utils.py:49-91)."""
    seq_pos = poses[:, :3]
    pairs: List[Tuple[int, int]] = []
    l = 0
    n = seq_pos.shape[0]
    while l < n:
        r = min(l + int(clip_s * fps), n - 1)
        group = seq_pos[l:r]
        if group.shape[0] == 0:
            break
        dists = np.linalg.norm(group[:, None, :] - avoid_pos[None], axis=-1)
        if dists.min() > min_dist:
            pairs.append((l, r))
            avoid_pos = np.concatenate(
                [avoid_pos, np.unique(group, axis=0)], axis=0)
            l = r + int(fps)
            continue
        near = np.where(dists.min(axis=1) <= min_dist + 1.0)[0] + l
        l = int(near.max()) + 1
    return pairs, avoid_pos


# ---------------------------------------------------------------------------
# stage 3: sound insertion (numpy mixing, ffmpeg-free)
# ---------------------------------------------------------------------------


def assign_sounds_to_sequence(seq_dir: Path, esc50: ESC50Meta,
                              categories: List[str], frame_pairs,
                              fps: float, sample_rate: int,
                              rng: np.random.Generator,
                              difficulty_level: str) -> None:
    """Mix one random ESC-50 clip of an allowed category into each selected
    slot of the sequence's soundtrack; write audio.wav + the range/category
    meta file the sound-map consumes (reference assign_sound_to_video,
    audio_utils.py:125-227, without the video mux)."""
    poses = np.loadtxt(seq_dir / "poses.txt")
    duration_s = len(poses) / fps
    track = np.zeros(int(duration_s * sample_rate) + sample_rate,
                     np.float32)
    meta_lines = []
    for (s_frame, e_frame) in frame_pairs:
        cat = categories[int(rng.integers(len(categories)))]
        paths = esc50.paths_for(cat)
        if not paths:
            continue
        clip_path = paths[int(rng.integers(len(paths)))]
        clip, _ = read_wav(clip_path, sample_rate)
        start = int(s_frame / fps * sample_rate)
        end = min(start + clip.shape[0], track.shape[0])
        track[start:end] += clip[:end - start]
        meta_lines.append(f"{s_frame},{e_frame},{clip_path},{cat}")
    write_wav(seq_dir / "audio.wav", np.clip(track, -1, 1), sample_rate)
    meta = seq_dir / f"range_and_audio_meta_{difficulty_level}.txt"
    meta.write_text("\n".join(meta_lines))


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


DEFAULT_CONFIG = (Path(__file__).resolve().parents[2] / "config"
                  / "generate_dataset.yaml")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data-dir", default="",
                        help="overrides data_paths.avlmaps_data_dir")
    parser.add_argument("--scene-dir", default="",
                        help="Matterport3D scene dir (habitat rendering); "
                             "overrides data_paths.habitat_scene_dir")
    parser.add_argument("--esc50-meta", default="")
    parser.add_argument("--esc50-audio", default="")
    parser.add_argument("--fetch", action="store_true",
                        help="download the dataset archive if absent "
                             "(needs gdown + network)")
    parser.add_argument("--config", default=str(DEFAULT_CONFIG),
                        help="entry config (reference "
                             "config/generate_dataset.yaml analogue)")
    args = parser.parse_args(argv)

    # the exists() fallback applies ONLY to the repo default (a source
    # checkout without config/ still runs); an explicit --config typo must
    # fail loudly, not silently render with default knobs
    if args.config == str(DEFAULT_CONFIG) and not Path(args.config).exists():
        cfg = load_config(None)
    else:
        cfg = load_config(args.config)
    cc = cfg.sound_data_collect_params
    rng = np.random.default_rng(cc.seed)
    data_root = Path(args.data_dir or cfg.data_paths.avlmaps_data_dir)
    scene_root = args.scene_dir or cfg.data_paths.habitat_scene_dir
    esc50_meta = args.esc50_meta or cfg.data_paths.esc50_meta_path
    esc50_audio = args.esc50_audio or cfg.data_paths.esc50_audio_dir
    if args.fetch:
        fetch_dataset(data_root)
    dataset = data_root / "vlmaps_dataset"
    if not dataset.exists():
        dataset = data_root / "avlmaps_dataset"
    if cfg.scene_names:
        scene_dirs = [dataset / name for name in cfg.scene_names]
        missing = [d.name for d in scene_dirs if not d.exists()]
        if missing:
            print(f"warning: configured scene_names not found on disk: "
                  f"{', '.join(missing)}")
        if len(missing) == len(scene_dirs):
            # none of the configured MP3D names exist (custom dataset):
            # fall back to whatever directories are actually present
            print("falling back to the scene directories present in "
                  f"{dataset}")
            scene_dirs = sorted([d for d in dataset.iterdir() if d.is_dir()])
    else:
        scene_dirs = sorted([d for d in dataset.iterdir() if d.is_dir()])

    for scene_dir in scene_dirs:
        poses_path = scene_dir / "poses.txt"
        if poses_path.exists() and scene_root:
            scene_name = scene_dir.name.split("_")[0]
            scene_path = (Path(scene_root) / scene_name
                          / f"{scene_name}.glb")
            generate_scene_data(scene_dir, scene_path,
                                np.loadtxt(poses_path),
                                data_cfg=cfg.data_cfg)

        if not (esc50_meta and esc50_audio):
            continue
        esc50 = ESC50Meta(esc50_meta, esc50_audio)
        categories = cfg.sound_config.level_categories(cc.difficulty)
        avoid = np.full((1, 3), np.inf, np.float32)
        audio_video = scene_dir / "audio_video"
        if not audio_video.exists():
            continue
        for seq_dir in sorted(d for d in audio_video.iterdir()
                              if d.is_dir()):
            poses = np.loadtxt(seq_dir / "poses.txt")
            pairs, avoid = select_audio_frames(
                poses, avoid, cc.fps, min_dist=cc.min_dist_between_sound)
            assign_sounds_to_sequence(seq_dir, esc50, categories, pairs,
                                      cc.fps, cc.sample_rate, rng,
                                      cc.difficulty)
        print(f"audio generated for {scene_dir.name}")


if __name__ == "__main__":
    main()
