"""Audio dataset: directory scan → pfft arrays (the port's own copy of
``ddim_audio_tpu/data/audio_dataset.py``, numpy only).

``AudioDataset(path, f_size, t_size, virtual_samplerate, axis="CTF", HPI)``
yields ``[2, t_size, f_size]`` float32 arrays. ``get_dataset`` makes the
deterministic 90/10 train/test split: a shuffle with seed **1010** that
leaves the ambient numpy RNG state as it was. ``batch_iterator`` yields numpy
batches, optionally decoded on a thread pool.
"""

from __future__ import annotations

import collections
import os
import struct
import threading

import numpy as np

from .codec import STFTConfig, num_samples, read_audio, wav2pfft

_AUDIO_EXTS = (".wav", ".npy")


def audio_length(path: str, target_samplerate: int) -> int | None:
    """Resampled sample count from file metadata alone — no decode.

    .npy: memory-mapped shape. .wav: RIFF fmt/data chunk walk (PCM and
    IEEE-float). Returns None when the header can't be parsed (caller falls
    back to a full decode)."""
    try:
        if path.endswith(".npy"):
            arr = np.load(path, mmap_mode="r")
            return int(arr.shape[0])
        with open(path, "rb") as f:
            riff = f.read(12)
            if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
                return None
            sr = None
            block_align = None
            data_bytes = None
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
                if cid == b"fmt ":
                    # odd-sized chunks carry a RIFF pad byte — skip it here
                    # too, or the walk misaligns on the next header
                    fmt = f.read(size + (size & 1))
                    sr = struct.unpack("<I", fmt[4:8])[0]
                    block_align = struct.unpack("<H", fmt[12:14])[0]
                elif cid == b"data":
                    data_bytes = size
                    break
                else:
                    f.seek(size + (size & 1), os.SEEK_CUR)
            if not (sr and block_align and data_bytes is not None):
                return None
            frames = data_bytes // block_align
            if sr == target_samplerate:
                return frames
            # half-up (int(round()) would round exact .5 ties to even and
            # shift the window count)
            return int(frames * target_samplerate / sr + 0.5)
    except Exception:
        return None


class AudioDataset:
    """Yields (pfft [2, t_size, f_size], 0) per item.

    Clips longer than t_size·hop samples contribute multiple items (one per
    non-overlapping window); shorter clips are zero-padded. ``axis`` supports
    "CTF" (the only order configs/audio.yml uses)."""

    def __init__(
        self,
        path: str,
        f_size: int = 256,
        t_size: int = 1024,
        virtual_samplerate: int = 48000,
        axis: str = "CTF",
        HPI: bool = False,
        cache_size: int = 16,
        **_ignored,
    ):
        if axis != "CTF":
            raise NotImplementedError(f"axis order {axis!r}")
        self.cfg = STFTConfig(
            f_size=f_size, virtual_samplerate=virtual_samplerate, HPI=HPI
        )
        self.t_size = t_size
        self.window = num_samples(self.cfg, t_size)
        # decoded-waveform LRU: windows of the same clip share one decode
        self._cache: collections.OrderedDict[str, np.ndarray] = (
            collections.OrderedDict()
        )
        self._cache_size = int(cache_size)
        self._lock = threading.Lock()

        files = []
        for root, _, names in os.walk(path):
            for name in sorted(names):
                if name.lower().endswith(_AUDIO_EXTS):
                    files.append(os.path.join(root, name))
        files.sort()
        if not files:
            raise FileNotFoundError(f"{path} contains no audio files")

        # index: (file, window_start); lengths come from file headers — the
        # init scan decodes nothing
        self._items: list[tuple[str, int]] = []
        self._lengths: dict[str, int] = {}
        for f in files:
            n = self._length_of(f)
            self._lengths[f] = n
            n_windows = max(1, n // self.window)
            for w in range(n_windows):
                self._items.append((f, w * self.window))

    def _length_of(self, path: str) -> int:
        n = audio_length(path, self.cfg.virtual_samplerate)
        if n is not None:
            return n
        return len(self._wave(path))

    def _wave(self, path: str) -> np.ndarray:
        with self._lock:
            if path in self._cache:
                self._cache.move_to_end(path)
                return self._cache[path]
        wave = read_audio(path, self.cfg.virtual_samplerate)
        with self._lock:
            self._cache[path] = wave
            while len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)
        return wave

    def __len__(self) -> int:
        return len(self._items)

    def __getitem__(self, i: int):
        path, start = self._items[i]
        wave = self._wave(path)
        seg = wave[start : start + self.window]
        if len(seg) < self.window:
            seg = np.pad(seg, (0, self.window - len(seg)))
        return wav2pfft(seg, self.cfg, self.t_size), 0


class Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


def get_dataset(args, config):
    """Dataset factory: AUDIO only; validates the path; deterministic 90/10
    split with seed 1010 while preserving the ambient numpy RNG state."""
    dataset, test_dataset = None, None
    if config.data.dataset == "AUDIO":
        path = config.data.path
        if not isinstance(path, str):
            raise Exception(f"Need to provide path of data. get {path}")
        if not os.path.isdir(path):
            raise NotADirectoryError(f"{path} is not a directory")
        if not os.listdir(path):
            raise FileNotFoundError(f"{path} do not contains files")
        kwargs = vars(config.data.dataset_kwargs)
        dataset = AudioDataset(path=path, **kwargs)

    if test_dataset is None and dataset is not None:
        num_items = len(dataset)
        indices = list(range(num_items))
        random_state = np.random.get_state()
        np.random.seed(1010)
        np.random.shuffle(indices)
        np.random.set_state(random_state)
        split = int(num_items * 0.9)
        test_dataset = Subset(dataset, indices[split:])
        dataset = Subset(dataset, indices[:split])

    return dataset, test_dataset


def batch_iterator(dataset, batch_size: int, *, shuffle: bool, seed: int = 0,
                   drop_last: bool = False, num_workers: int = 0,
                   prefetch: int = 2):
    """Epoch iterator over numpy batches.

    num_workers=0 loads on the calling thread (configs/audio.yml's
    setting). num_workers>0
    decodes items on a thread pool and keeps ``prefetch`` batches in flight
    so the accelerator isn't host-bound (the threads spend their time in
    numpy FFT/IO, which releases the GIL)."""
    rng = np.random.default_rng(seed)
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    batches = []
    for i in range(0, len(order), batch_size):
        idx = order[i : i + batch_size]
        if drop_last and len(idx) < batch_size:
            break
        batches.append(idx)

    def assemble(idx, item_of):
        xs = np.stack([item_of(int(j))[0] for j in idx])
        ys = np.zeros((len(idx),), np.int32)
        return xs, ys

    if num_workers <= 0:
        for idx in batches:
            yield assemble(idx, dataset.__getitem__)
        return

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        def fetch(idx):
            futs = [pool.submit(dataset.__getitem__, int(j)) for j in idx]
            return futs

        inflight = collections.deque()
        bi = 0
        while bi < len(batches) and len(inflight) <= prefetch:
            inflight.append((batches[bi], fetch(batches[bi])))
            bi += 1
        while inflight:
            idx, futs = inflight.popleft()
            items = [f.result() for f in futs]
            if bi < len(batches):
                inflight.append((batches[bi], fetch(batches[bi])))
                bi += 1
            xs = np.stack([it[0] for it in items])
            ys = np.zeros((len(idx),), np.int32)
            yield xs, ys
