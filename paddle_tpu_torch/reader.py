"""Data pipeline: reader decorators, Dataset / Sampler / DataLoader.

The port of ``paddle_tpu/reader.py``: the reader decorators (:46-247,
pure-Python generator combinators), ``Dataset`` and its kinds, the
samplers, ``default_collate_fn`` and ``DataLoader`` (:248-831).

* ``DataLoader.from_generator``: a background thread prefetches batches
  into a bounded queue and (``use_double_buffer``) copies each onto the
  explicit device there (``_prefetch_device_put``), so the host-to-device
  copy overlaps the previous step. The device is ``places`` if given,
  else the dygraph tracer's, else the card. A mesh of more than one
  device is ROADMAP A8 and raises.
* ``DataLoader(dataset, ...)``: sampler, collate and worker processes
  (shared-memory transport) or threads; batches are numpy arrays.
"""

from __future__ import annotations

import itertools
import queue
import random as _random
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

__all__ = [
    # decorators
    "batch", "shuffle", "buffered", "cache", "chain", "compose", "firstn",
    "map_readers", "xmap_readers", "ComposeNotAligned",
    # datasets / samplers / loader
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "Sampler", "SequenceSampler", "RandomSampler", "BatchSampler",
    "DataLoader", "default_collate_fn",
]


# ---------------------------------------------------------------------------
# reader decorators (reference: python/paddle/reader/decorator.py)
# ---------------------------------------------------------------------------

def batch(reader: Callable, batch_size: int, drop_last: bool = False):
    """Group samples into lists of `batch_size`."""

    def batched():
        b = []
        for sample in reader():
            b.append(sample)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batched


def shuffle(reader: Callable, buf_size: int, seed: Optional[int] = None):
    """Pool-based shuffle with a `buf_size` reservoir."""

    def shuffled():
        rng = _random.Random(seed)
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            rng.shuffle(buf)
            yield from buf

    return shuffled


def buffered(reader: Callable, size: int):
    """Background-thread prefetch of up to `size` samples."""

    _end = object()

    def buffered_reader():
        q: queue.Queue = queue.Queue(maxsize=size)
        err: List[BaseException] = []

        def produce():
            try:
                for sample in reader():
                    q.put(sample)
            except BaseException as e:  # surface worker errors to consumer
                err.append(e)
            finally:
                q.put(_end)

        t = threading.Thread(target=produce, name="pt-reader-buffer",
                             daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _end:
                break
            yield item
        if err:
            raise err[0]

    return buffered_reader


def cache(reader: Callable):
    all_data: List[Any] = []
    filled = [False]

    def cached():
        if not filled[0]:
            all_data.extend(reader())
            filled[0] = True
        yield from all_data

    return cached


def chain(*readers):
    def chained():
        for r in readers:
            yield from r()

    return chained


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, check_alignment: bool = True):
    """Zip readers into flat tuples of their samples. With
    check_alignment=True (default), raises ComposeNotAligned if readers have
    different lengths (reference: reader/decorator.py compose); with False,
    stops at the longest reader, padding missing slots with None."""

    _missing = object()

    def composed():
        iters = [r() for r in readers]
        if check_alignment:
            for items in itertools.zip_longest(*iters, fillvalue=_missing):
                if any(i is _missing for i in items):
                    raise ComposeNotAligned(
                        "compose: input readers yielded different lengths")
                yield tuple(x for i in items
                            for x in (i if isinstance(i, tuple) else (i,)))
        else:
            for items in zip(*iters):  # stop at the shortest (reference)
                yield tuple(x for i in items
                            for x in (i if isinstance(i, tuple) else (i,)))

    return composed


def firstn(reader: Callable, n: int):
    def firstn_reader():
        yield from itertools.islice(reader(), n)

    return firstn_reader


def map_readers(func: Callable, *readers):
    def mapped():
        for items in zip(*[r() for r in readers]):
            yield func(*items)

    return mapped


def xmap_readers(mapper: Callable, reader: Callable, process_num: int,
                 buffer_size: int, order: bool = False):
    """Parallel map over a reader with `process_num` worker threads."""

    _end = object()

    def xmapped():
        in_q: queue.Queue = queue.Queue(buffer_size)
        out_q: queue.Queue = queue.Queue(buffer_size)
        errors: List[BaseException] = []

        def feed():
            try:
                for i, sample in enumerate(reader()):
                    in_q.put((i, sample))
            except BaseException as e:
                errors.append(e)
            finally:
                for _ in range(process_num):
                    in_q.put(_end)

        def work():
            try:
                while True:
                    item = in_q.get()
                    if item is _end:
                        return
                    i, sample = item
                    out_q.put((i, mapper(sample)))
            except BaseException as e:
                errors.append(e)
            finally:
                # always post the sentinel so the consumer can't deadlock on
                # a failed worker
                out_q.put(_end)

        threading.Thread(target=feed, name="pt-reader-xmap-feed",
                         daemon=True).start()
        for i in range(process_num):
            threading.Thread(target=work, name=f"pt-reader-xmap-{i}",
                             daemon=True).start()
        done = 0
        pending = {}
        next_idx = 0
        while done < process_num:
            item = out_q.get()
            if item is _end:
                done += 1
                continue
            i, mapped = item
            if not order:
                yield mapped
            else:
                pending[i] = mapped
                while next_idx in pending:
                    yield pending.pop(next_idx)
                    next_idx += 1
        if errors:
            raise errors[0]
        if order:
            for i in sorted(pending):
                yield pending[i]

    return xmapped


# ---------------------------------------------------------------------------
# Dataset / Sampler (reference: python/paddle/fluid/dataloader/)
# ---------------------------------------------------------------------------

class Dataset:
    """Map-style dataset: __getitem__ + __len__."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise TypeError("IterableDataset is not subscriptable")

    def __len__(self):
        raise TypeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence[np.ndarray]):
        self.tensors = [np.asarray(t) for t in tensors]
        n = len(self.tensors[0])
        if any(len(t) != n for t in self.tensors):
            raise ValueError("all tensors must share dim 0")

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)

    def __getitem__(self, idx):
        out = []
        for ds in self.datasets:
            s = ds[idx]
            out.extend(s if isinstance(s, tuple) else (s,))
        return tuple(out)

    def __len__(self):
        return min(len(d) for d in self.datasets)


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self) -> Iterator[int]:
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement: bool = False,
                 num_samples: Optional[int] = None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = self.generator or np.random
        if self.replacement:
            return iter(rng.randint(0, n, self.num_samples).tolist())
        idx = np.arange(n)
        rng.shuffle(idx)
        return iter(idx[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """Yields lists of indices (reference: dataloader/batch_sampler.py)."""

    def __init__(self, dataset=None, sampler: Optional[Sampler] = None,
                 shuffle: bool = False, batch_size: int = 1,
                 drop_last: bool = False):
        super().__init__(dataset)
        if sampler is None:
            sampler = (RandomSampler(dataset) if shuffle
                       else SequenceSampler(dataset))
        self.sampler = sampler
        self.batch_size = int(batch_size)
        self.drop_last = drop_last

    def __iter__(self):
        b = []
        for idx in self.sampler:
            b.append(idx)
            if len(b) == self.batch_size:
                yield b
                b = []
        if b and not self.drop_last:
            yield b

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size


def default_collate_fn(batch_list):
    """List of samples → stacked numpy arrays (field-wise)."""
    first = batch_list[0]
    if isinstance(first, (tuple, list)):
        return tuple(default_collate_fn([s[i] for s in batch_list])
                     for i in range(len(first)))
    if isinstance(first, dict):
        return {k: default_collate_fn([s[k] for s in batch_list])
                for k in first}
    return np.stack([np.asarray(s) for s in batch_list])


# ---------------------------------------------------------------------------
# DataLoader
# ---------------------------------------------------------------------------

_END = object()


def _prefetch_device_put(batch, device=None, mesh=None):
    """A prefetched batch copied onto ``device`` (None: the dygraph
    tracer's device, else the card): every array of a tuple, list or dict
    as a tensor there (64-bit types narrowed as the executor's feeds
    are). The reference shards a batch over an active mesh's 'dp' axis;
    the port has no mesh yet (ROADMAP A8), so a mesh of more than one
    device raises."""
    import torch

    if mesh is not None and int(np.prod(list(
            getattr(mesh, "shape", {}).values()) or [1])) > 1:
        raise NotImplementedError(
            "a DataLoader sharding batches over a mesh is not in the port "
            "yet (ROADMAP A8)")
    from .dygraph.varbase import as_tensor
    from .dygraph.tracer import get_tracer, resolve_device

    if isinstance(device, (list, tuple)):
        device = device[0] if device else None
    if device is None:
        tracer = get_tracer()
        device = tracer.device if tracer is not None else \
            resolve_device(None)
    device = torch.device(device)

    def put(x):
        if isinstance(x, (tuple, list)):
            return type(x)(put(v) for v in x)
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor):
            return x.to(device, non_blocking=True)
        return as_tensor(np.asarray(x), "cpu").to(device,
                                                  non_blocking=True)

    return put(batch)


class _GeneratorLoader:
    """from_generator loader: queue-fed, iterable (reference:
    fluid/reader.py GeneratorLoader). The prefetch thread copies each
    batch onto the loader's device (``_prefetch_device_put``).

    Resumable: ``state_dict()`` returns the stream cursor (batches the
    current iteration has delivered, skipped ones included) and
    ``set_state()`` arms the NEXT iteration to fast-forward past that
    many batches — the exact-resume hook the crash-consistent checkpoint
    stack (paddle_tpu/checkpoint.py, ElasticRunner) stores and restores.
    Exactness requires the underlying generator to be deterministic.

    Elastic worlds: ``set_world(world_size, trainer_id)`` turns the
    loader into one member of a round-robin partition of the SAME
    deterministic global stream — trainer t of W delivers exactly the
    batches whose global index ≡ t (mod W). The cursor is the GLOBAL
    stream position, so a checkpoint saved at one world size restores
    into any other: every new trainer arms the same global cursor and
    takes its own residue class — the reader re-split of a world-size-
    changing resume needs no data munging (reader.cursor_resplits
    counts the world-changing restores)."""

    def __init__(self, feed_list=None, capacity: int = 16,
                 return_list: bool = False, use_device_put: bool = True,
                 mesh=None):
        self.feed_list = feed_list or []
        self.capacity = capacity
        self.return_list = return_list
        self.use_device_put = use_device_put
        self.mesh = mesh
        self._gen: Optional[Callable] = None
        self._places = None
        self._position = 0        # GLOBAL cursor of the live iteration
        self._skip_next = 0       # armed by set_state for the next iteration
        self._world_size = 1
        self._trainer_id = 0

    # -- resumable cursor --------------------------------------------------
    def set_world(self, world_size: int, trainer_id: int):
        """Partition the global stream round-robin: this loader delivers
        batches whose global index ≡ trainer_id (mod world_size)."""
        world_size = int(world_size)
        trainer_id = int(trainer_id)
        if world_size < 1 or not 0 <= trainer_id < world_size:
            raise ValueError(
                f"set_world: need 0 <= trainer_id < world_size, got "
                f"trainer {trainer_id} of {world_size}")
        self._world_size = world_size
        self._trainer_id = trainer_id
        return self

    def state_dict(self) -> Dict[str, int]:
        """{'batches': N} — GLOBAL position in the (deterministic) batch
        stream (plus the world shape when one is configured)."""
        state = {"batches": int(self._position)}
        if self._world_size > 1:
            state["world_size"] = self._world_size
            state["trainer_id"] = self._trainer_id
        return state

    def set_state(self, state: Dict[str, int]):
        """Arm the next iteration to discard the first N GLOBAL batches,
        so the first delivered batch is the one a restored run expects.
        The cursor is global: a state saved by any member of any world
        size restores into this loader's (possibly different) world —
        the re-split is just this loader's own residue class applied
        past the same cursor."""
        self._skip_next = max(0, int(state.get("batches", 0)))
        self._position = self._skip_next
        saved_world = int(state.get("world_size", 1))
        if saved_world != self._world_size:
            from .core import telemetry as _telemetry
            _telemetry.counter_add(
                "reader.cursor_resplits", 1, saved_world=saved_world,
                world=self._world_size, trainer=self._trainer_id)

    # -- configuration ----------------------------------------------------
    def set_sample_generator(self, generator, batch_size: int,
                             drop_last: bool = True, places=None):
        self.set_sample_list_generator(
            batch(lambda: generator(), batch_size, drop_last), places)
        return self

    def set_sample_list_generator(self, generator, places=None):
        def to_batches():
            for sample_list in generator():
                yield default_collate_fn(sample_list)

        self.set_batch_generator(to_batches, places)
        return self

    def set_batch_generator(self, generator, places=None):
        self._gen = generator
        self._places = places
        return self

    # -- iteration ---------------------------------------------------------
    def __iter__(self):
        if self._gen is None:
            raise RuntimeError(
                "DataLoader not configured — call set_sample_generator / "
                "set_sample_list_generator / set_batch_generator first")
        names = [getattr(v, "name", str(v)) for v in self.feed_list]
        q: queue.Queue = queue.Queue(maxsize=self.capacity)
        err: List[BaseException] = []

        def produce():
            try:
                for b in self._gen():
                    if self.use_device_put:
                        b = _prefetch_device_put(b, self._places,
                                                 self.mesh)
                    q.put(b)
            except BaseException as e:
                err.append(e)
            finally:
                q.put(_END)

        threading.Thread(target=produce, name="pt-reader-prefetch",
                         daemon=True).start()
        skip, self._skip_next = self._skip_next, 0
        self._position = 0
        import time as _time

        from .core import telemetry as _telemetry
        while True:
            # consumer-side queue wait: the training loop blocked on the
            # prefetch thread — the goodput ledger's data_wait phase
            t_wait = _time.perf_counter()
            item = q.get()
            _telemetry.observe("reader.data_wait_ms",
                               (_time.perf_counter() - t_wait) * 1e3,
                               kind="timer")
            if item is _END:
                break
            index = self._position           # global index of this batch
            self._position += 1
            if skip > 0:
                # fast-forward to the restored cursor: the batch was
                # produced (deterministic stream) but never delivered
                skip -= 1
                continue
            if index % self._world_size != self._trainer_id:
                # another trainer's residue class — consumed from the
                # global stream (the cursor advances) but not delivered
                continue
            if self.return_list or not names:
                yield list(item) if isinstance(item, tuple) else [item]
            else:
                arrays = item if isinstance(item, (tuple, list)) else (item,)
                yield dict(zip(names, arrays))
        if err:
            raise err[0]


class DataLoader:
    """Two construction modes, mirroring the reference:

    * ``DataLoader.from_generator(feed_list, capacity)`` then
      ``set_*_generator`` — iterable loader yielding feed dicts.
    * ``DataLoader(dataset, batch_size=.., shuffle=..)`` — map-style with
      sampler + collate + threaded workers.
    """

    def __init__(self, dataset: Optional[Dataset] = None, feed_list=None,
                 places=None, return_list: bool = True,
                 batch_sampler: Optional[BatchSampler] = None,
                 batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, collate_fn: Optional[Callable] = None,
                 num_workers: int = 0, use_buffer_reader: bool = True,
                 use_shared_memory: bool = True,
                 prefetch_factor: int = 2, timeout: float = 0,
                 worker_init_fn=None):
        self.dataset = dataset
        self.feed_list = feed_list or []
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = int(num_workers)
        # True: worker processes with shared-memory transport; False: a
        # thread pool
        self.use_shared_memory = bool(use_shared_memory)
        self.prefetch_factor = prefetch_factor
        self._iterable_dataset = isinstance(dataset, IterableDataset)
        if self._iterable_dataset:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        else:
            if batch_sampler is not None:
                self.batch_sampler = batch_sampler
            else:
                self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                                  batch_size=batch_size,
                                                  drop_last=drop_last)

    @staticmethod
    def from_generator(feed_list=None, capacity: int = 16, iterable: bool = True,
                       return_list: bool = False, use_double_buffer: bool = True,
                       use_multiprocess: bool = False,
                       drop_last: bool = True) -> _GeneratorLoader:
        # use_double_buffer: the prefetch thread copies each batch onto the
        # device, so the copy overlaps the previous step
        return _GeneratorLoader(feed_list, capacity, return_list,
                                use_device_put=use_double_buffer)

    def __len__(self):
        if self._iterable_dataset:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def _fetch(self, indices):
        samples = [self.dataset[i] for i in indices]
        return self.collate_fn(samples)

    def _emit(self, collated):
        if self.return_list or not self.feed_list:
            return list(collated) if isinstance(collated, tuple) else [collated]
        names = [getattr(v, "name", str(v)) for v in self.feed_list]
        arrays = collated if isinstance(collated, (tuple, list)) else (collated,)
        return dict(zip(names, arrays))

    def _iter_process_workers(self):
        """Fork-based worker processes with shared-memory batch transport
        (reference: dataloader/dataloader_iter.py _DataLoaderIterMultiProcess
        + memory/allocation/mmap_allocator.cc): each worker pulls index
        lists from a task queue, collates, copies every array of the
        batch into a multiprocessing.shared_memory block and ships only
        (name, dtype, shape) descriptors — Python-heavy preprocessing
        scales past the GIL, and large batches cross processes without
        being pickled through a pipe. In-order delivery via batch ids."""
        import multiprocessing as mp
        from multiprocessing import shared_memory

        ctx = mp.get_context("fork")
        # bounded task queue = backpressure: at most
        # num_workers * prefetch_factor batches in flight, so /dev/shm
        # holds a bounded working set, not the whole epoch
        depth = max(1, self.num_workers * int(self.prefetch_factor))
        task_q = ctx.Queue(maxsize=depth)
        result_q = ctx.Queue()
        batches = list(self.batch_sampler)
        nw = self.num_workers

        dataset, collate = self.dataset, self.collate_fn

        def worker():
            while True:
                job = task_q.get()
                if job is None:
                    return
                bid, indices = job
                try:
                    collated = collate([dataset[i] for i in indices])
                    arrays = collated if isinstance(collated, (tuple, list)) \
                        else (collated,)
                    descs = []
                    for a in arrays:
                        a = np.ascontiguousarray(a)
                        shm = shared_memory.SharedMemory(
                            create=True, size=max(a.nbytes, 1))
                        np.ndarray(a.shape, a.dtype,
                                   buffer=shm.buf)[...] = a
                        descs.append((shm.name, str(a.dtype), a.shape))
                        shm.close()
                    result_q.put((bid, descs, None))
                except Exception as e:        # surface, don't hang
                    result_q.put((bid, None, repr(e)))

        procs = [ctx.Process(target=worker, daemon=True)
                 for _ in range(nw)]
        for p in procs:
            p.start()

        def feed():
            for bid, indices in enumerate(batches):
                task_q.put((bid, indices))      # blocks at depth
            for _ in range(nw):
                task_q.put(None)

        feeder = threading.Thread(target=feed, name="pt-reader-shmem-feed",
                                  daemon=True)
        feeder.start()
        pending: Dict[int, Any] = {}

        def unlink_descs(descs):
            for name, _, _ in descs or ():
                try:
                    shm = shared_memory.SharedMemory(name=name)
                    shm.close()
                    shm.unlink()
                except FileNotFoundError:
                    pass

        try:
            next_bid = 0
            received = 0
            while received < len(batches):
                # bounded waits + worker-liveness check: a worker killed
                # without posting a result (OOM kill, segfault in user
                # dataset code) must raise, not hang the training loop.
                # A worker killed while IDLE leaves its queued tasks for
                # the survivors, so a crash alone is not fatal — raise
                # only once results also stop flowing (progress stall).
                import time as _time

                last_progress = _time.monotonic()
                while True:
                    try:
                        bid, descs, err = result_q.get(timeout=5.0)
                        break
                    except queue.Empty:
                        crashed = [p.exitcode for p in procs
                                   if not p.is_alive()
                                   and p.exitcode not in (0, None)]
                        stalled = _time.monotonic() - last_progress > 60.0
                        if crashed and (stalled or
                                        all(not p.is_alive()
                                            for p in procs)):
                            raise RuntimeError(
                                f"DataLoader worker died (exitcodes "
                                f"{crashed}) and results stalled with "
                                f"{len(batches) - received} batches "
                                f"outstanding — a batch was likely lost "
                                f"with the worker")
                        if all(not p.is_alive() for p in procs):
                            raise RuntimeError(
                                "all DataLoader workers exited with "
                                f"{len(batches) - received} batches "
                                "outstanding")
                received += 1
                if err is not None:
                    raise RuntimeError(
                        f"DataLoader worker failed on batch {bid}: {err}")
                pending[bid] = descs
                while next_bid in pending:
                    arrays = []
                    for name, dtype, shape in pending.pop(next_bid):
                        shm = shared_memory.SharedMemory(name=name)
                        arrays.append(np.array(np.ndarray(
                            shape, dtype, buffer=shm.buf)))
                        shm.close()
                        shm.unlink()
                    collated = tuple(arrays) if len(arrays) != 1 \
                        else arrays[0]
                    yield self._emit(collated)
                    next_bid += 1
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=5)
            # reclaim shm of batches never consumed (error / early close)
            for descs in pending.values():
                unlink_descs(descs)
            try:
                while True:
                    _, descs, _ = result_q.get_nowait()
                    unlink_descs(descs)
            except queue.Empty:
                pass

    def __iter__(self):
        if self._iterable_dataset:
            def gen():
                b = []
                for sample in self.dataset:
                    b.append(sample)
                    if len(b) == self.batch_size:
                        yield self.collate_fn(b)
                        b = []
                if b and not self.drop_last:
                    yield self.collate_fn(b)

            for collated in gen():
                yield self._emit(collated)
            return

        if self.num_workers <= 0:
            for indices in self.batch_sampler:
                yield self._emit(self._fetch(indices))
            return

        if self.use_shared_memory:
            yield from self._iter_process_workers()
            return

        # threaded workers with in-order delivery
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(self.num_workers) as pool:
            batches = list(self.batch_sampler)
            depth = self.num_workers * self.prefetch_factor
            futures: "queue.Queue" = queue.Queue()
            it = iter(batches)
            submitted = 0
            for indices in itertools.islice(it, depth):
                futures.put(pool.submit(self._fetch, indices))
                submitted += 1
            while submitted > 0:
                f = futures.get()
                submitted -= 1
                nxt = next(it, None)
                if nxt is not None:
                    futures.put(pool.submit(self._fetch, nxt))
                    submitted += 1
                yield self._emit(f.result())
