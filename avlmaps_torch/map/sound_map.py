"""SoundMap: AudioCLIP features per detected sound event + pose tracks.

Counterpart of ``avlmaps_tpu/map/sound_map.py`` (reference
avlmaps/map/sound_map.py): per audio-video sequence, split
the soundtrack at silences, embed each event with the audio tower, and store
the robot positions covered while the event played.  A text query retrieves
events by clamped-scale audio-text logits.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from avlmaps_torch.config import SoundCollectParams, SoundConfig
from avlmaps_torch.geometry.transforms import pose_vec_to_tf
from avlmaps_torch.utils.audio import (convert_time_ranges_to_frame_ranges,
                                       extract_audio_from_video,
                                       get_five_second_context, read_wav,
                                       segment_audio_with_silence,
                                       setup_audio_paths)
from avlmaps_torch.utils.category_matching import find_similar_category_id


class SoundMap:
    """The sound event database; the AudioCLIP encoder it makes runs on
    ``device`` (default ``"cuda"``; raises without a card).  The pickle
    holds numpy arrays only, so both packages read each other's."""

    def __init__(self, avlmaps_data_dir: str = "",
                 sound_config: Optional[SoundConfig] = None,
                 sound_data_collect_config: Optional[SoundCollectParams]
                 = None,
                 is_ambiguous: bool = False, is_real: bool = False,
                 audioclip_encoder=None,
                 device: Union[str, torch.device] = "cuda"):
        self.avlmaps_data_dir = avlmaps_data_dir
        self.sound_config = sound_config or SoundConfig()
        self.collect_config = sound_data_collect_config or \
            SoundCollectParams()
        self.difficulty_level = self.collect_config.difficulty
        self.manual_str = "_manual" if is_ambiguous else ""
        self.is_real = is_real
        self.sound_categories = self.sound_config.level_categories(
            self.difficulty_level)
        self.audio_database: Optional[Dict[int, Dict]] = None
        self._encoder = audioclip_encoder
        self.device = device
        self._text_feat_cache: Optional[np.ndarray] = None

    def _init_audioclip(self):
        """Lazy AudioCLIP (reference sound_map.py:37-47), seeded random
        weights unless an encoder was given."""
        if self._encoder is None:
            from avlmaps_torch.models.audioclip import AudioClipEncoder

            self._encoder = AudioClipEncoder(device=self.device)
        return self._encoder

    # -- creation ------------------------------------------------------------

    def create_sound_map(self, data_dir: str) -> Dict[int, Dict]:
        """Build the audio event database for one scene
        (reference create_audio_map_batch, audio_mapping_utils.py:26-122).

        Per sequence dir under <data_dir>/audio_video/: use a pre-extracted
        ``audio.wav`` if present (ffmpeg-free path) else demux the
        ``output_with_audio{_manual}_<level>.mp4``.
        """
        cc = self.collect_config
        _, seq_dirs = setup_audio_paths(data_dir)
        seq_dirs = seq_dirs[:cc.considered_seq_num_per_scene]
        if seq_dirs:  # scene without audio: skip the AudioCLIP init
            enc = self._init_audioclip()

        features: List[np.ndarray] = []
        locations: List[List[np.ndarray]] = []
        for seq_dir in seq_dirs:
            wav_path = seq_dir / "audio.wav"
            if wav_path.exists():
                audio, sr = read_wav(wav_path, cc.sample_rate)
            else:
                video = seq_dir / (f"output_with_audio{self.manual_str}"
                                   f"_{self.difficulty_level}.mp4")
                if not video.exists():
                    continue
                with tempfile.TemporaryDirectory() as tmp:
                    wav_path = Path(tmp) / "audio.wav"
                    extract_audio_from_video(video, wav_path)
                    audio, sr = read_wav(wav_path, cc.sample_rate)
            ranges, tracks = segment_audio_with_silence(
                audio, cc.silence_duration_s, cc.silence_threshold, sr)
            if not tracks:
                continue
            # centre 5 s context, int16 scale (reference audio_mapping:86 +
            # encode_audio context extraction)
            clips = []
            for t in tracks:
                ctx = get_five_second_context(t.astype(np.float32) * 32768.0,
                                              2.5, sr)
                clips.append(ctx if ctx is not None
                             else np.zeros(5 * sr, np.float32))
            feats = enc.encode_audio_batch(clips)
            features.extend(feats[i] for i in range(feats.shape[0]))

            frame_ranges = convert_time_ranges_to_frame_ranges(ranges, cc.fps)
            pose_path = seq_dir / "poses.txt"
            seq_poses = np.loadtxt(pose_path) if pose_path.exists() else \
                np.zeros((0, 7))
            if seq_poses.ndim == 1:
                seq_poses = seq_poses[None]
            for (s, e) in frame_ranges:
                seg = seq_poses[s:e]
                locations.append([pose_vec_to_tf(v)[:3, 3] for v in seg])

        self.audio_database = {
            i: {"audio_features": f, "locations": locs}
            for i, (f, locs) in enumerate(zip(features, locations))}
        save_path = (Path(data_dir) / "audio_video" /
                     f"audio_data{self.manual_str}"
                     f"_{self.difficulty_level}.pkl")
        os.makedirs(save_path.parent, exist_ok=True)
        with open(save_path, "wb") as f:
            pickle.dump(self.audio_database, f)
        return self.audio_database

    def load_sound_map(self, data_dir: str) -> Dict[int, Dict]:
        """(reference sound_map.py:73-84)."""
        filename = "audio_data.pkl" if self.is_real else \
            f"audio_data{self.manual_str}_{self.difficulty_level}.pkl"
        with open(Path(data_dir) / "audio_video" / filename, "rb") as f:
            self.audio_database = pickle.load(f)
        return self.audio_database

    # -- queries -------------------------------------------------------------

    def get_all_audio_features_and_locations(self):
        """(reference sound_map.py:86-97)."""
        feats, locs = [], []
        for i in range(len(self.audio_database)):
            feats.append(self.audio_database[i]["audio_features"])
            locs.append(self.audio_database[i]["locations"])
        return np.stack(feats, axis=0), locs

    def _audio_text_logits(self) -> np.ndarray:
        enc = self._init_audioclip()
        audio_feats, _ = self.get_all_audio_features_and_locations()
        if self._text_feat_cache is None:
            # one text-tower forward per category list, reused by every query
            self._text_feat_cache = enc.encode_text(
                [[c] for c in self.sound_categories])
        return enc.audio_text_logits(audio_feats, self._text_feat_cache)

    def get_pos(self, name: str):
        """Locations of the event best matching the named sound
        (reference sound_map.py:102-120: per-category retrieval argmax)."""
        logits = self._audio_text_logits()
        _, locations = self.get_all_audio_features_and_locations()
        cat_id = find_similar_category_id(name, self.sound_categories)
        retrieval_id = int(np.argmax(logits[:, cat_id]))
        return locations[retrieval_id]

    def get_pos_with_audio(self, audio_path: str, sample_rate: int):
        """Query by example audio clip (reference sound_map.py:122-133)."""
        if not os.path.exists(audio_path):
            return []
        enc = self._init_audioclip()
        audio, sr = read_wav(audio_path, sample_rate)
        query = enc.encode_audio_batch([audio * 32768.0])
        audio_feats, locations = self.get_all_audio_features_and_locations()
        retrieval_id = int(np.argmax(audio_feats @ query.T))
        return locations[retrieval_id]

    def get_distribution_and_locations(self, name: str):
        """Per-event probabilities for a sound name + all event locations
        (reference sound_map.py:135-153: logits column min-max normalised)."""
        logits = self._audio_text_logits()
        _, locations = self.get_all_audio_features_and_locations()
        cat_id = find_similar_category_id(name, self.sound_categories)
        probs = logits[:, cat_id]
        rng = probs.max() - probs.min()
        probs = (probs - probs.min()) / (rng if rng > 0 else 1.0)
        return probs, locations
