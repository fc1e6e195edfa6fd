"""Host-side audio machinery: wav IO, silence segmentation, context windows.

Counterpart of ``avlmaps_tpu/utils/audio.py`` (reference
avlmaps/utils/audio_utils.py), host numpy throughout.  librosa and ffmpeg
are not assumed: wav decoding uses the stdlib ``wave`` module + numpy,
resampling uses scipy, and video->audio extraction shells out to ffmpeg
only when present.
Segmentation is a pure array function (the reference mixes file IO in).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import wave
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np


def read_wav(path, target_sample_rate: Optional[int] = None
             ) -> Tuple[np.ndarray, int]:
    """Load a PCM wav as mono float32 in [-1, 1] (librosa.load semantics)."""
    with wave.open(str(path), "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        width = f.getsampwidth()
        channels = f.getnchannels()
        raw = f.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    if target_sample_rate and target_sample_rate != sr:
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(target_sample_rate, sr)
        data = resample_poly(data, target_sample_rate // g, sr // g)
        sr = target_sample_rate
    return data.astype(np.float32), sr


def write_wav(path, audio: np.ndarray, sample_rate: int) -> None:
    """Write mono float32 [-1, 1] as 16-bit PCM."""
    pcm = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def extract_audio_from_video(video_path, output_audio_path) -> None:
    """Demux a video's audio track to wav via ffmpeg
    (reference audio_utils.py:508-512)."""
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            "ffmpeg is required to extract audio from video; provide "
            "pre-extracted .wav files instead")
    if os.path.exists(output_audio_path):
        os.remove(output_audio_path)
    subprocess.run(["ffmpeg", "-y", "-i", str(video_path), "-vn",
                    str(output_audio_path)], check=True,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def segment_audio_with_silence(audio: np.ndarray,
                               silence_duration_s: float = 1.0,
                               silence_thres: float = 0.0,
                               sample_rate: int = 44100
                               ) -> Tuple[List[Tuple[float, float]],
                                          List[np.ndarray]]:
    """Split a waveform into sound events separated by silence.

    Matches reference segment_audio_with_silence (audio_utils.py:515-546):
    samples with amplitude > thres are active; active runs closer than
    ``silence_duration_s`` merge into one segment.  Returns per-segment
    (start_s, end_s) ranges and sample tracks.
    """
    indices = np.where(audio > silence_thres)[0]
    if indices.size == 0:
        return [], []
    gap = int(silence_duration_s * sample_rate)
    ranges: List[Tuple[float, float]] = []
    tracks: List[np.ndarray] = []
    l = r = indices[0]
    for idx in indices:
        if idx - r < gap:
            r = idx
            continue
        ranges.append((l / sample_rate, r / sample_rate))
        tracks.append(audio[l:r])
        l = r = idx
    ranges.append((l / sample_rate, r / sample_rate))
    tracks.append(audio[l:r])
    return ranges, tracks


def convert_time_ranges_to_frame_ranges(time_ranges, fps: float
                                        ) -> List[Tuple[int, int]]:
    """(reference audio_utils.py:549-550)."""
    return [(int(s * fps), int(e * fps)) for (s, e) in time_ranges]


def get_five_second_context(audio: np.ndarray, center_s: float,
                            sample_rate: int) -> Optional[np.ndarray]:
    """5-second window centred at ``center_s``, zero-padded at the tail
    (reference get_five_second_contexts_audio, audio_utils.py:569-583)."""
    if center_s - 2.5 > (audio.shape[-1] - 1) / sample_rate:
        return None
    s = int((center_s - 2.5) * sample_rate)
    e = int((center_s + 2.5) * sample_rate)
    subset = audio[max(s, 0):e]
    out = np.zeros(5 * sample_rate, np.float32)
    out[:subset.shape[-1]] = subset
    return out


def setup_audio_paths(data_dir) -> Tuple[Path, List[Path]]:
    """Audio-video sequence directory layout
    (dataset/README.md: audio_video/<seq_id>/...)."""
    audio_video_dir = Path(data_dir) / "audio_video"
    seq_dirs = sorted([d for d in audio_video_dir.iterdir() if d.is_dir()]) \
        if audio_video_dir.exists() else []
    return audio_video_dir, seq_dirs


def get_level_categories(difficulty_level: str, sound_config) -> List[str]:
    """Difficulty level -> flat ESC-50 category list
    (reference audio_utils.py:230-236)."""
    from avlmaps_torch.config import SoundConfig

    if isinstance(sound_config, SoundConfig):
        return sound_config.level_categories(difficulty_level)
    cats: List[str] = []
    for major in sound_config["difficulty"][difficulty_level]:
        cats.extend(sound_config["major_categories"][major])
    return cats
