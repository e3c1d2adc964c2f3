"""ImageNet input pipeline (PIL + numpy, threaded decode) + synthetic data.

The port's own copy of ``fp8_quantization_tpu/data/imagenet.py`` (which
imports no JAX; this package imports nothing of the JAX package).  Val
Resize(image_size+24) + CenterCrop(image_size), train RandomResizedCrop +
HFlip, ImageNet mean/std, ImageFolder layout.  Outputs NHWC float32 numpy
batches; ``calibration/calibrate.py`` moves them to the device.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np


def prefetch_iter(gen, depth: int = 2):
    """Run ``gen`` on a daemon thread, buffering up to ``depth`` items.

    Double-buffering for the input pipeline: batch N+1 decodes while the
    device runs batch N (the torch-DataLoader prefetch the reference gets
    from multiprocess workers, imagenet_dataloaders.py:94-99).  Ordering is
    preserved; worker exceptions re-raise at the consumer."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    done = object()

    def worker():
        try:
            for item in gen:
                q.put(item)
            q.put(done)
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            q.put(exc)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            return
        if isinstance(item, BaseException):
            raise item
        yield item

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _pil_interp(name: str):
    from PIL import Image

    return {
        "nearest": Image.NEAREST, "bilinear": Image.BILINEAR,
        "bicubic": Image.BICUBIC, "lanczos": Image.LANCZOS,
        "box": Image.BOX, "hamming": Image.HAMMING,
    }[name]

_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _list_image_folder(root: str):
    """(paths, labels, class_names) for an ImageFolder-layout directory."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    paths, labels = [], []
    for idx, c in enumerate(classes):
        cdir = os.path.join(root, c)
        for fn in sorted(os.listdir(cdir)):
            if fn.lower().endswith(_EXTS):
                paths.append(os.path.join(cdir, fn))
                labels.append(idx)
    return paths, np.asarray(labels, np.int32), classes


def _decode_val(path: str, image_size: int,
                interpolation: str = "bilinear") -> np.ndarray:
    """Resize(image_size+24) + CenterCrop(image_size), normalized NHWC.

    Reference: imagenet_dataloaders.py:75-84 (val transform).
    """
    from PIL import Image

    img = Image.open(path).convert("RGB")
    # torchvision Resize(n) on the *shorter* side
    w, h = img.size
    target = image_size + 24
    if w < h:
        nw, nh = target, max(1, round(h * target / w))
    else:
        nw, nh = max(1, round(w * target / h)), target
    img = img.resize((nw, nh), _pil_interp(interpolation))
    left = (nw - image_size) // 2
    top = (nh - image_size) // 2
    img = img.crop((left, top, left + image_size, top + image_size))
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def _decode_train(path: str, image_size: int, rng: np.random.RandomState,
                  interpolation: str = "bilinear") -> np.ndarray:
    """RandomResizedCrop(image_size) + HFlip, normalized NHWC.

    Reference: imagenet_dataloaders.py:64-72 (train transform; default
    scale (0.08, 1.0), ratio (3/4, 4/3)).
    """
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(0.08, 1.0)
        log_ratio = rng.uniform(np.log(3 / 4), np.log(4 / 3))
        ratio = np.exp(log_ratio)
        cw = int(round(np.sqrt(target_area * ratio)))
        ch = int(round(np.sqrt(target_area / ratio)))
        if 0 < cw <= w and 0 < ch <= h:
            left = rng.randint(0, w - cw + 1)
            top = rng.randint(0, h - ch + 1)
            img = img.crop((left, top, left + cw, top + ch))
            break
    else:  # fallback: center crop of the largest fitting square
        s = min(w, h)
        img = img.crop(((w - s) // 2, (h - s) // 2,
                        (w - s) // 2 + s, (h - s) // 2 + s))
    img = img.resize((image_size, image_size), _pil_interp(interpolation))
    if rng.rand() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


class ImageFolderDataset:
    """Batched iterator over an ImageFolder tree, threaded decode."""

    def __init__(self, root: str, image_size: int = 224, batch_size: int = 64,
                 train: bool = False, seed: int = 0, num_workers: int = 8,
                 shard_id: int = 0, num_shards: int = 1,
                 drop_remainder: bool = False,
                 interpolation: str = "bilinear", prefetch: int = 2):
        self.paths, self.labels, self.classes = _list_image_folder(root)
        self.image_size = image_size
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        self.num_workers = num_workers
        self.drop_remainder = drop_remainder
        self.interpolation = interpolation
        self.prefetch = prefetch
        self._epoch = 0
        # per-host shard (multi-host data parallelism)
        self.paths = self.paths[shard_id::num_shards]
        self.labels = self.labels[shard_id::num_shards]

    def __len__(self):
        n = len(self.paths)
        return n // self.batch_size if self.drop_remainder else \
            (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        it = self._batches()
        if self.prefetch > 0:
            # decode batch N+1 on a background thread while the device runs
            # batch N (double-buffering)
            return prefetch_iter(it, self.prefetch)
        return it

    def _batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = np.arange(len(self.paths))
        # fresh shuffle + augmentation draws every epoch (torch DataLoader
        # shuffle=True semantics); deterministic given (seed, epoch)
        rng = np.random.RandomState(self.seed + self._epoch)
        self._epoch += 1
        if self.train:
            rng.shuffle(order)
        with ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, len(order), self.batch_size):
                idx = order[start:start + self.batch_size]
                if self.drop_remainder and len(idx) < self.batch_size:
                    break
                if self.train:
                    seeds = rng.randint(0, 2 ** 31, size=len(idx))
                    imgs = list(pool.map(
                        lambda a: _decode_train(self.paths[a[0]], self.image_size,
                                                np.random.RandomState(a[1]),
                                                self.interpolation),
                        zip(idx, seeds)))
                else:
                    imgs = list(pool.map(
                        lambda i: _decode_val(self.paths[i], self.image_size,
                                              self.interpolation), idx))
                yield np.stack(imgs), self.labels[idx]


class SyntheticImageNet:
    """Deterministic procedural images (no dataset on disk).

    Class-dependent low-frequency patterns + noise, ImageNet-normalized.
    Used for throughput benchmarks and pipeline tests; accuracy numbers on
    real ImageNet require the real dataset via ImageFolderDataset.  Under
    data parallelism every rank draws the same global batches from the
    seed and keeps its rows (parallel.local_rows), so the ranks together
    see the single-process run's batches.
    """

    def __init__(self, image_size: int = 224, batch_size: int = 64,
                 num_batches: int = 8, num_classes: int = 1000, seed: int = 0):
        self.image_size = image_size
        self.batch_size = batch_size
        self.num_batches = num_batches
        self.num_classes = num_classes
        self.seed = seed

    def __len__(self):
        return self.num_batches

    def _make_batch(self, rng: np.random.RandomState):
        s = self.image_size
        y = rng.randint(0, self.num_classes, self.batch_size).astype(np.int32)
        xx, yy = np.meshgrid(np.linspace(0, 1, s), np.linspace(0, 1, s))
        imgs = np.empty((self.batch_size, s, s, 3), np.float32)
        for i, cls in enumerate(y):
            f = 1.0 + (cls % 16)
            phase = (cls // 16) * 0.1
            base = 0.5 + 0.4 * np.sin(2 * np.pi * f * xx + phase) \
                * np.cos(2 * np.pi * f * yy)
            img = np.stack([base, np.roll(base, s // 7, 0),
                            np.roll(base, s // 5, 1)], axis=-1)
            img = img + rng.normal(0, 0.05, img.shape)
            imgs[i] = np.clip(img, 0, 1)
        return ((imgs - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32), y

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        for _ in range(self.num_batches):
            yield self._make_batch(rng)


def make_dataloaders(data_dir: Optional[str], image_size: int = 224,
                     batch_size: int = 64, num_workers: int = 8, seed: int = 0,
                     shard_id: int = 0, num_shards: int = 1,
                     interpolation: str = "bilinear"):
    """(train_iter, val_iter) from an ImageNet directory tree with train/ and
    val/ subfolders (reference ImageNetDataLoaders, imagenet_dataloaders.py:22-115),
    falling back to synthetic data when data_dir is unset/missing."""
    if data_dir and os.path.isdir(os.path.join(data_dir, "val")):
        train_dir = os.path.join(data_dir, "train")
        train = ImageFolderDataset(
            train_dir, image_size, batch_size, train=True, seed=seed,
            num_workers=num_workers, shard_id=shard_id, num_shards=num_shards,
            drop_remainder=True,
            interpolation=interpolation) if os.path.isdir(train_dir) else None
        val = ImageFolderDataset(
            os.path.join(data_dir, "val"), image_size, batch_size, train=False,
            seed=seed, num_workers=num_workers, shard_id=shard_id,
            num_shards=num_shards, interpolation=interpolation)
        return train, val
    synth = SyntheticImageNet(image_size, batch_size, num_batches=8, seed=seed)
    return synth, synth
