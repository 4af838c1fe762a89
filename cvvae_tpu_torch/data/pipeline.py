"""Host-side streaming data pipeline.

Port of ``cvvae_tpu/data/pipeline.py`` (framework-free, copied): the
reference's torchdata/webdataset stack as plain composable Python
iterators, feeding the card through ``device_prefetch`` (pinned memory,
non-blocking copies) in place of the JAX package's ``jax.device_put``:

* tar "webdataset" shard reader with sorted members and a
  warn-and-continue handler on corrupt shards
  [lvdm/data/datapipes.py:40-119]
* csv / jsonl metadata readers [datapipes.py:122-153,
  datapipe_utils.py:199-214]
* per-host + per-worker sharding [datapipe_utils.py:78-92]
* weighted SampleMultiplexer with per-host seed offset
  [datapipe_utils.py:288-340]
* buffered shuffle, cycle/repeat, batch + dict collation
  [datapipe_utils.py:109-142,343-372]
"""

from __future__ import annotations

import csv
import glob
import json
import os
import random
import tarfile
import warnings
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np


# --------------------------- sources ---------------------------------------

def list_files(urls_or_dir, file_mask: str = "*") -> List[str]:
    """FileLister: directory+mask or explicit list (datapipe_utils.py:186+)."""
    if isinstance(urls_or_dir, (list, tuple)):
        return sorted(urls_or_dir)
    return sorted(glob.glob(os.path.join(urls_or_dir, file_mask)))


def cycle(items: Sequence, repeat: Optional[int]) -> Iterator:
    """Repeat the file list `repeat` times (None = forever)."""
    n = 0
    while repeat is None or n < repeat:
        yield from items
        n += 1


def shard(it: Iterable, shard_id: int, num_shards: int) -> Iterator:
    """Round-robin sharding across hosts x workers
    (apply_sharding, datapipe_utils.py:78-92)."""
    for i, item in enumerate(it):
        if i % num_shards == shard_id:
            yield item


def buffered_shuffle(it: Iterable, bufsize: int, seed: int) -> Iterator:
    """Reservoir-style streaming shuffle (wds .shuffle equivalent)."""
    if bufsize <= 1:
        yield from it
        return
    rng = random.Random(seed)
    buf: list = []
    for item in it:
        if len(buf) < bufsize:
            buf.append(item)
            continue
        idx = rng.randrange(bufsize)
        yield buf[idx]
        buf[idx] = item
    rng.shuffle(buf)
    yield from buf


# --------------------------- readers ----------------------------------------

def warn_and_continue(exn: Exception) -> bool:
    """webdataset.warn_and_continue analogue (yaml:118-119)."""
    warnings.warn(f"data pipeline: skipping sample after {exn!r}")
    return True


def tar_sample_reader(paths: Iterable[str],
                      handler: Callable[[Exception], bool] = warn_and_continue
                      ) -> Iterator[Dict[str, bytes]]:
    """Read webdataset-style tars -> dicts of {ext: bytes} grouped by
    basename, members sorted (TarArchiveLoaderWithHandler,
    lvdm/data/datapipes.py:40-119).  Adds "__key__" and "__url__"."""
    for path in paths:
        try:
            with tarfile.open(path, "r") as tf:
                members = sorted((m for m in tf.getmembers() if m.isfile()),
                                 key=lambda m: m.name)
                current_key = None
                sample: Dict[str, bytes] = {}
                for m in members:
                    base, dot, ext = m.name.partition(".")
                    if base != current_key:
                        if sample and current_key is not None:
                            yield sample
                        current_key = base
                        sample = {"__key__": base, "__url__": path}
                    try:
                        sample[ext.lower()] = tf.extractfile(m).read()
                    except Exception as exn:  # corrupt member
                        if not handler(exn):
                            raise
                if sample and current_key is not None:
                    yield sample
        except Exception as exn:  # corrupt shard
            if not handler(exn):
                raise


def csv_reader(paths: Iterable[str]) -> Iterator[Dict[str, str]]:
    for path in paths:
        with open(path, newline="") as f:
            yield from csv.DictReader(f)


def jsonl_reader(paths: Iterable[str]) -> Iterator[Dict]:
    """JsonlParser analogue (lvdm/data/datapipes.py:122-153)."""
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    yield json.loads(line)


# --------------------------- mixing / batching ------------------------------

def sample_multiplexer(pipes: Dict[Iterator, float], seed: int) -> Iterator:
    """Weighted random interleave; a pipe that ends is dropped
    (SampleMultiplexer, datapipe_utils.py:288-340 — seeded seed+rank)."""
    rng = random.Random(seed)
    active = [(it, w) for it, w in pipes.items()]
    while active:
        total = sum(w for _, w in active)
        r = rng.random() * total
        acc = 0.0
        for i, (it, w) in enumerate(active):
            acc += w
            if r <= acc:
                try:
                    yield next(it)
                except StopIteration:
                    active.pop(i)
                break


def dict_collate(samples: List[Dict]) -> Dict[str, np.ndarray]:
    """Stack same-keyed arrays; pass through non-arrays as lists
    (dict_collation_fn, datapipe_utils.py:109-142)."""
    out: Dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.number)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


def dict_collate_concat(samples: List[Dict], *,
                        concat_keys: Sequence[str] = (),
                        rank0_keys: Sequence[str] = ()) -> Dict:
    """Concat-capable collation (dict_collation_fn_with_concat,
    datapipe_utils.py:145-183): batch keys are the INTERSECTION of the
    samples' keys; array keys in ``concat_keys`` concatenate on axis 0
    (variable leading extents, e.g. pre-batched clips) instead of
    stacking; scalar keys in ``rank0_keys`` keep only the first sample's
    value."""
    keys = set(samples[0])
    for s in samples[1:]:
        keys &= set(s)
    out: Dict = {}
    for key in keys:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = (np.concatenate(vals, axis=0) if key in concat_keys
                        else np.stack(vals))
        elif isinstance(vals[0], (int, float, np.number)):
            out[key] = vals[0] if key in rank0_keys else np.asarray(vals)
        else:
            out[key] = vals
    return out


def batcher(it: Iterable, batch_size: int,
            collate: Callable = dict_collate) -> Iterator:
    buf = []
    for item in it:
        buf.append(item)
        if len(buf) == batch_size:
            yield collate(buf)
            buf = []


def mapped(it: Iterable, fn: Callable, *,
           handler: Callable[[Exception], bool] = warn_and_continue
           ) -> Iterator:
    """map with warn-and-continue on per-sample failures
    (decoder.py:142-146)."""
    for item in it:
        try:
            out = fn(item)
        except Exception as exn:
            if not handler(exn):
                raise
            continue
        if out is not None:
            yield out


def parallel_mapped(it: Iterable, fn: Callable, *, num_workers: int = 4,
                    prefetch: Optional[int] = None,
                    use_processes: bool = False,
                    handler: Callable[[Exception], bool] = warn_and_continue
                    ) -> Iterator:
    """``mapped`` with a worker pool: the reference runs 4 DataLoader
    worker *processes* per rank (datapipe_utils.py:365-367); here the
    usual decode work (cv2/PIL/numpy) releases the GIL, so a thread pool
    gives the same parallelism without pickling or fork overhead.  For
    decoders that do NOT release the GIL (pure-Python parsing, some
    codec wrappers), ``use_processes=True`` switches to a process pool —
    ``fn`` and the samples must then be picklable.  Results are yielded
    in input order; per-sample failures warn-and-continue.
    ``prefetch`` bounds the in-flight window (default 2x workers)."""
    if num_workers <= 1:
        yield from mapped(it, fn, handler=handler)
        return
    from collections import deque
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    pool_cls = ProcessPoolExecutor if use_processes else ThreadPoolExecutor
    window = prefetch or 2 * num_workers
    with pool_cls(num_workers) as ex:
        futures: deque = deque()
        src = iter(it)
        exhausted = False
        while True:
            while not exhausted and len(futures) < window:
                try:
                    futures.append(ex.submit(fn, next(src)))
                except StopIteration:
                    exhausted = True
            if not futures:
                return
            fut = futures.popleft()
            try:
                out = fut.result()
            except Exception as exn:
                if not handler(exn):
                    raise
                continue
            if out is not None:
                yield out


class _PipelineError:
    def __init__(self, exn):
        self.exn = exn


def prefetched(it: Iterable, size: int = 4) -> Iterator:
    """Run the upstream pipeline in a daemon thread with a bounded
    queue, so host-side IO (tar reads, decode, collation) overlaps the
    consumer's device step (DataLoader prefetching semantics).  An
    exception upstream is raised in the consumer."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=size)
    _end = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(_end)
        except BaseException as exn:  # re-raised in the consumer
            q.put(_PipelineError(exn))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is _end:
            return
        if isinstance(item, _PipelineError):
            raise item.exn
        yield item


def device_prefetch(it: Iterable, device, size: int = 2) -> Iterator:
    """Batches onto ``device`` one ``size`` ahead: each numpy array is
    copied into pinned host memory and then to the card with
    ``non_blocking=True``, so the next batch's transfer overlaps the
    current step.  On the CPU the arrays become tensors as they are."""
    from collections import deque

    import torch

    device = torch.device(device)

    def put(batch):
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                t = torch.from_numpy(np.ascontiguousarray(v))
                if device.type == "cuda":
                    t = t.pin_memory().to(device, non_blocking=True)
                out[k] = t
            else:
                out[k] = v
        return out

    buf: deque = deque()
    src = iter(it)
    try:
        for _ in range(max(1, size)):
            buf.append(put(next(src)))
    except StopIteration:
        pass
    while buf:
        out = buf.popleft()
        try:
            buf.append(put(next(src)))
        except StopIteration:
            pass
        yield out


def filtered(it: Iterable, pred: Callable) -> Iterator:
    return (x for x in it if pred(x))


def selected(it: Iterable, keys: Sequence[str]) -> Iterator:
    """frame_select analogue (lvdm/data/map_func.py)."""
    return ({k: s[k] for k in keys if k in s} for s in it)


# --------------------------- dataset assembly -------------------------------

def build_webdataset_pipeline(*, urls_or_dir, file_mask: str = "*.tar",
                              repeat: Optional[int] = 1,
                              shardshuffle: int = 0, sample_shuffle: int = 0,
                              decoder: Callable = None,
                              select_keys: Optional[Sequence[str]] = None,
                              batch_size: int = 1, seed: int = 0,
                              shard_id: int = 0, num_shards: int = 1,
                              num_workers: int = 4, prefetch: int = 2,
                              decode_processes: bool = False,
                              handler=warn_and_continue) -> Iterator:
    """tar branch of create_single_dataset (datapipe_utils.py:186-285).

    ``num_workers`` parallelises the decode (the reference's
    num_workers=4 DataLoader semantics); ``decode_processes`` runs the
    decoder in worker processes for GIL-holding decoders (the decoder
    must be picklable); ``prefetch`` batches are built ahead in a
    background thread."""
    files = list_files(urls_or_dir, file_mask)
    it = cycle(files, repeat)
    if shardshuffle:
        it = buffered_shuffle(it, shardshuffle, seed)
    it = shard(it, shard_id, num_shards)
    it = tar_sample_reader(it, handler)
    if decoder is not None:
        it = parallel_mapped(it, decoder, num_workers=num_workers,
                             use_processes=decode_processes,
                             handler=handler)
    if sample_shuffle:
        it = buffered_shuffle(it, sample_shuffle, seed + 1)
    if select_keys:
        it = selected(it, select_keys)
    it = batcher(it, batch_size)
    if prefetch:
        it = prefetched(it, prefetch)
    return it


def build_metadata_pipeline(*, urls_or_dir, file_mask: str = "*.csv",
                            repeat: Optional[int] = 1,
                            sample_shuffle: int = 0,
                            decoder: Callable = None,
                            select_keys: Optional[Sequence[str]] = None,
                            batch_size: int = 1, seed: int = 0,
                            shard_id: int = 0, num_shards: int = 1,
                            num_workers: int = 4, prefetch: int = 2,
                            decode_processes: bool = False,
                            handler=warn_and_continue) -> Iterator:
    """csv/jsonl branch of create_single_dataset."""
    files = list_files(urls_or_dir, file_mask)
    reader = jsonl_reader if file_mask.endswith((".jsonl", ".json")) else csv_reader
    it = reader(cycle(files, repeat))
    it = shard(it, shard_id, num_shards)
    if sample_shuffle:
        it = buffered_shuffle(it, sample_shuffle, seed)
    if decoder is not None:
        it = parallel_mapped(it, decoder, num_workers=num_workers,
                             use_processes=decode_processes,
                             handler=handler)
    if select_keys:
        it = selected(it, select_keys)
    it = batcher(it, batch_size)
    if prefetch:
        it = prefetched(it, prefetch)
    return it


def build_multi_dataset(pipelines: Dict[str, Iterator],
                        weights: Dict[str, float], *, seed: int = 58,
                        shard_id: int = 0) -> Iterator:
    """create_multi_dataset: weighted mix with per-rank seed
    (datapipe_utils.py:288-340)."""
    pipes = {pipelines[name]: weights[name] for name in pipelines}
    return sample_multiplexer(pipes, seed + shard_id)
