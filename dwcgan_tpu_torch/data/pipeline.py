"""Training batches: the port's own copies of `Batch`, `synthetic_batch`
and the threaded `DataPipeline` (`dwcgan_tpu/data/pipeline.py:28-64,
299-426`), and `pin_batch` / `to_device`, which put a host batch on the
device.

`synthetic_batch` and `DataPipeline` give the same numpy arrays as the JAX
package's for the same arguments.  The pipeline runs on one process
(`process_index` 0 of 1) unless the caller says otherwise: under data
parallel (`cli/train.py`) each rank feeds its share of every global batch.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Iterator, NamedTuple, Sequence

import numpy as np
import torch

from dwcgan_tpu_torch.data.labels import all_domains
from dwcgan_tpu_torch.text.synthesis import TextSynthesizer
from dwcgan_tpu_torch.text.vocab import Vocab, tokens_to_ids
from dwcgan_tpu_torch.utils.profiling import span


class Batch(NamedTuple):
    """One training batch; everything fixed-shape.

    image:     [B, H, W, 3] float32 in [-1, 1]
    src_label: [B, num_cls] float32 in {0, 1}
    trg_label: [B, num_cls] float32 in {0, 1}
    txt:       [B, max_len + 2] int token ids (BOS ... EOS PAD*)
    txt_len:   [B] int (BOS + words + EOS)
    """

    image: object
    src_label: object
    trg_label: object
    txt: object
    txt_len: object


def synthetic_batch(batch_size: int, image_size: int = 128, num_cls: int = 8,
                    max_text_len: int = 80, seed: int = 0,
                    dataset: str = "CelebA") -> Batch:
    """Random images + genuinely synthesized commands from random label
    pairs (numpy arrays)."""
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)
    synth = TextSynthesizer(rng)
    vocab = Vocab(dataset)
    domains = all_domains(num_cls)
    src = domains[nprng.integers(0, len(domains), batch_size)]
    trg = domains[nprng.integers(0, len(domains), batch_size)]
    cmds = [synth.labels2text(s, t).split() for s, t in zip(src, trg)]
    txt, lens = tokens_to_ids(cmds, vocab, max_len=max_text_len)
    image = nprng.uniform(-1.0, 1.0, (batch_size, image_size, image_size, 3)).astype(np.float32)
    return Batch(image, src.astype(np.float32), trg.astype(np.float32), txt, lens)


class DataPipeline:
    """Threaded prefetching loader over a map-style dataset whose items are
    the 5-tuple of `CelebADataset`; yields numpy `Batch`es forever.

    Deterministic: workers take numbered batches from the index stream and
    the consumer re-emits them in stream order through a reorder buffer,
    and a dataset with `item(index, epoch)` draws its augmentation keyed by
    (seed, host salt, epoch, index), so the stream does not depend on
    thread scheduling.  A worker's exception is raised in the consumer.
    `start` skips that many batches of the stream without building them
    (a resumed run continues where the saved one stopped).
    """

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 prefetch: int = 4, seed: int = 0, process_index: int = 0,
                 process_count: int = 1, start: int = 0):
        if not 0 <= process_index < process_count:
            raise ValueError(f"process {process_index} of {process_count}")
        if len(dataset) < batch_size * process_count:
            raise ValueError(
                "dataset smaller than one global batch "
                f"({len(dataset)} rows, {batch_size} x {process_count} needed)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.start = start
        if process_count > 1 and hasattr(dataset, "reseed_augmentation"):
            dataset.reseed_augmentation(process_index)

    def _index_stream(self) -> Iterator[tuple]:
        """(epoch, indices) per batch: every process draws the same
        permutation per epoch (seeded by `seed` alone) and takes a disjoint
        strided slice of it; the last partial batch of an epoch is dropped."""
        rng = np.random.default_rng(self.seed)
        n = len(self.dataset)
        epoch = 0
        while True:
            mine = rng.permutation(n)[self.process_index:: self.process_count]
            stop = len(mine) - len(mine) % self.batch_size
            for i in range(0, stop, self.batch_size):
                yield epoch, mine[i: i + self.batch_size]
            epoch += 1

    def _collate(self, idxs: Sequence[int], epoch: int) -> Batch:
        if hasattr(self.dataset, "item"):
            items = [self.dataset.item(int(i), epoch) for i in idxs]
        else:
            items = [self.dataset[int(i)] for i in idxs]
        return Batch(*(np.stack([it[k] for it in items]) for k in range(5)))

    def __iter__(self) -> Iterator[Batch]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stream = enumerate(self._index_stream())
        for _ in range(self.start):
            next(stream)
        lock = threading.Lock()
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    with lock:
                        seq, (epoch, idxs) = next(stream)
                    item = (seq, self._collate(idxs, epoch))
                except Exception as e:  # raised again in the consumer
                    item = (-1, e)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if isinstance(item[1], Exception):
                    return

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            want = self.start
            ahead: dict = {}
            while True:
                # the consumer's wait for the next batch in stream order;
                # `ready`: batches decoded and waiting when it asked
                with span("data.next", ready=q.qsize() + len(ahead)):
                    while want not in ahead:
                        seq, item = q.get()
                        if isinstance(item, Exception):
                            raise RuntimeError("data pipeline worker failed") from item
                        ahead[seq] = item
                    batch = ahead.pop(want)
                yield batch
                want += 1
        finally:
            stop.set()


def pin_batch(batch: Batch) -> Batch:
    """numpy batch -> torch tensors in pinned host memory, from which a
    `non_blocking` copy to the card overlaps the host's work.  `txt_len`
    stays in pageable memory: it never leaves the host."""
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32)).pin_memory()
    return Batch(f32(batch.image), f32(batch.src_label), f32(batch.trg_label),
                 torch.as_tensor(np.asarray(batch.txt, np.int64)).pin_memory(),
                 torch.as_tensor(np.asarray(batch.txt_len, np.int64)))


def to_device(batch: Batch, device) -> Batch:
    """numpy batch -> torch tensors on `device`, through pinned memory and
    `non_blocking` copies when it is the card.  The image keeps its NHWC
    bytes (the generator reads them as a channels_last view); `txt_len`
    stays on the host, where the LSTM reads how many steps to run (no
    device sync)."""
    dev = torch.device(device)
    with span("data.to_device"):
        if dev.type == "cuda":
            b = pin_batch(batch)
            return Batch(*(t.to(dev, non_blocking=True) for t in b[:4]), b.txt_len)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
        return Batch(f32(batch.image), f32(batch.src_label), f32(batch.trg_label),
                     torch.as_tensor(np.asarray(batch.txt, np.int64)),
                     torch.as_tensor(np.asarray(batch.txt_len, np.int64)))
