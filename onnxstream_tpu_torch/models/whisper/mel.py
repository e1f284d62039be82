"""Whisper log-mel spectrogram frontend.

NumPy re-implementation of the reference browser example's Kaldi/knf-style
feature extractor (reference examples/Whisper_wasm/index.html:191-600):

  * 16 kHz mono audio, 25 ms Hann windows (400 samples) at 10 ms hops (160);
  * power spectrum over num_fft/2+1 bins;
  * 80 librosa-style slaney-scale, slaney-normalized triangular mel bands
    built over num_fft_bins+1 coefficients (index.html:228-333);
  * log10 with 1e-10 floor, clamp at global max - 8, then (x+4)/4
    (process_features, index.html:536-553);
  * pad 1500 zero frames, truncate to 3000 frames (30 s), transpose to
    (n_mels, frames) (index.html:555-572).

Counterpart of ``onnxstream_tpu/models/whisper/mel.py``, the same numpy code:
the feature stays on the host and matches the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000
WINDOW_SIZE = 400  # 25 ms
HOP = 160  # 10 ms
N_MELS = 80
PAD_FRAMES = 1500
MAX_FRAMES = 3000


def _mel_scale_slaney(freq):
    freq = np.asarray(freq, np.float64)
    return np.where(freq <= 1000.0, freq * 3.0 / 200.0,
                    15.0 + 14.545078505785561 * np.log(np.maximum(freq, 1e-10) / 1000.0))


def _inverse_mel_scale_slaney(mel):
    mel = np.asarray(mel, np.float64)
    return np.where(mel <= 15.0, 200.0 / 3.0 * mel,
                    1000.0 * np.exp((mel - 15.0) * 0.06875177742094911))


def librosa_mel_banks(num_bins: int = N_MELS, window_size: int = WINDOW_SIZE,
                      sample_rate: int = SAMPLE_RATE, low_freq: float = 0.0,
                      high_freq: float = 0.0) -> np.ndarray:
    """(num_bins, window_size//2 + 1) filterbank matrix (reference
    melBanks_InitLibrosaMelBanks, index.html:228-333)."""
    num_fft_bins = window_size // 2
    nyquist = 0.5 * sample_rate
    hi = high_freq if high_freq > 0 else nyquist + high_freq
    fft_bin_width = sample_rate / window_size
    mel_low = _mel_scale_slaney(low_freq)
    mel_high = _mel_scale_slaney(hi)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    hz = fft_bin_width * np.arange(num_fft_bins + 1, dtype=np.float64)
    banks = np.zeros((num_bins, num_fft_bins + 1), np.float64)
    for b in range(num_bins):
        left = _inverse_mel_scale_slaney(mel_low + b * mel_delta)
        center = _inverse_mel_scale_slaney(mel_low + (b + 1) * mel_delta)
        right = _inverse_mel_scale_slaney(mel_low + (b + 2) * mel_delta)
        inside = (hz > left) & (hz < right)
        up = (hz - left) / (center - left)
        down = (right - hz) / (right - center)
        w = np.where(hz <= center, up, down)
        w = np.where(inside, w, 0.0)
        # slaney normalization (index.html:310-312)
        banks[b] = w * (2.0 / (right - left))
    return banks.astype(np.float32)


def log_mel_spectrogram(audio: np.ndarray, n_mels: int = N_MELS,
                        pad_to: int = MAX_FRAMES) -> np.ndarray:
    """audio (n_samples,) float32 in [-1,1] -> (1, n_mels, frames) float32."""
    audio = np.asarray(audio, np.float32)
    window = (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(WINDOW_SIZE) / WINDOW_SIZE)).astype(np.float32)
    n_frames = max(0, (len(audio) - WINDOW_SIZE) // HOP + 1)
    if n_frames == 0:
        feats = np.zeros((0, n_mels), np.float32)
    else:
        idx = np.arange(WINDOW_SIZE)[None, :] + HOP * np.arange(n_frames)[:, None]
        frames = audio[idx] * window  # (n_frames, 400)
        spec = np.fft.rfft(frames, axis=-1)
        power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)  # (n_frames, 201)
        banks = librosa_mel_banks(n_mels)
        feats = power @ banks.T  # (n_frames, n_mels)

    log_spec = np.log10(np.maximum(feats, 1e-10))
    if log_spec.size:
        log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    mel = (log_spec + 4.0) / 4.0

    # pad 1500 zero frames then truncate to 30 s (index.html:555-565)
    mel = np.concatenate([mel, np.zeros((PAD_FRAMES, n_mels), mel.dtype)], axis=0)
    mel = mel[:pad_to]
    if mel.shape[0] < pad_to:
        mel = np.concatenate([mel, np.zeros((pad_to - mel.shape[0], n_mels), mel.dtype)], axis=0)
    return mel.T[None].astype(np.float32)  # (1, n_mels, frames)


def read_16bit_raw_audio(path: str) -> np.ndarray:
    """Little-endian int16 mono 16 kHz raw file -> float32 [-1,1]
    (reference read_16bit_raw_audio, index.html:502-534)."""
    raw = np.fromfile(path, dtype="<i2")
    return (raw / 32768.0).astype(np.float32)
