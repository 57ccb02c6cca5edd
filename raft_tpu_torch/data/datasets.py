"""Flow datasets and the training input pipeline, the counterpart of
``raft_tpu/data/datasets.py`` (host-side numpy; copied, since the port
imports nothing of the JAX package).

The reference's ``core/datasets.py``: a ``FlowDataset`` base with dense and
sparse read paths, the five dataset classes (MpiSintel, FlyingChairs,
FlyingThings3D, KITTI, HD1K), replication for mixture weighting
(``__rmul__``, reference ``:99-102``), and ``fetch_dataloader`` with the
per-stage augmentation parameters and mixture weights (reference
``:205-240``). Given a ``root``, ``fetch_dataloader`` reads every stage's
datasets under it (the JAX package reads only FlyingChairs there and the
others under ``$RAFT_DATASETS``, the default of both when ``root`` is
None).

Batches are NHWC numpy dicts (``image1``/``image2`` float32 in [0, 255],
``flow``, ``valid``); ``train`` moves them to the card. Two loaders: a
thread prefetcher (``DataLoader``) and worker processes from a
``forkserver`` (``ProcessDataLoader``), which ``select_loader`` picks on
hosts of four or more cores. This module imports only numpy, the port's
data modules and ``resilience``: a worker process never imports torch, so
it never initialises the card.

Crash consistency: both loaders own a serializable ``LoaderState`` (seed,
epoch, sample cursor within the epoch's permutation, resilience counters).
Iteration consumes the deterministic epoch order from an explicit cursor,
advanced when a batch is *yielded to the consumer*, never at pump-fill
time, so the prefetch depth is invisible to the cursor; ``state()`` and
``load_state()`` round-trip it. Restoring mid-iteration drains the
in-flight prefetch pump: the live iterator stops at its next batch
boundary and the next iteration rebuilds the pump from the restored
cursor, so no consumed-but-unstepped batch is replayed or dropped.
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp
import random
from glob import glob
from typing import List, Optional, Sequence, Tuple

import numpy as np

from raft_tpu_torch.data import frame_utils
from raft_tpu_torch.data.augmentor import FlowAugmentor, SparseFlowAugmentor
from raft_tpu_torch.resilience import (ResilienceStats,
                                       StallWatchdog, active_injector,
                                       retry_with_backoff)

# Failure modes a single sample read can hit on a long run: a vanished
# or unreadable file (OSError covers FileNotFoundError / EIO from a
# flaky NFS mount) and a corrupt image/flow payload (decoders raise
# ValueError on truncated PNG/PFM/flo data).
_TRANSIENT_READ_ERRORS = (OSError, ValueError)


def _read_sample(dataset, index: int, retries: int = 2,
                 base_delay: float = 0.05,
                 max_substitutions: int = 8):
    """Fault-tolerant single-sample read.

    Retries transient errors with exponential backoff (a blip on the
    storage layer), then substitutes the next index — deterministically
    ``(index + k) % len`` for ``k = 1, 2, ...`` — when the sample is
    truly unreadable (one corrupt PNG must cost one logged substitution,
    not the epoch: the reference's ``f.result()`` re-raise would kill
    the run). Returns ``(sample, n_substituted, n_retried)`` where
    ``n_substituted`` is how many indices were skipped (0 on the normal
    path) and ``n_retried`` how many read attempts failed transiently
    before one succeeded (both feed ``ResilienceStats``). Raises only when ``max_substitutions + 1``
    consecutive indices are all unreadable — at that point the dataset,
    not a sample, is broken.
    """
    n = len(dataset)
    idx = int(index)
    last_err = None
    retried = 0
    for k in range(max_substitutions + 1):
        cand = (idx + k) % n

        def _once(cand=cand):
            active_injector().maybe_fail_sample(cand)
            return dataset[cand]

        def _count_retry(attempt, exc):
            nonlocal retried
            retried += 1

        try:
            sample = retry_with_backoff(
                _once, retries=retries, base_delay=base_delay,
                retry_on=_TRANSIENT_READ_ERRORS,
                describe=f"sample read (index {cand})",
                on_retry=_count_retry)
            if k:
                print(f"WARNING: sample {idx} unreadable; substituted "
                      f"index {cand} ({last_err})", flush=True)
            return sample, k, retried
        except _TRANSIENT_READ_ERRORS as e:
            last_err = e
    raise RuntimeError(
        f"{max_substitutions + 1} consecutive samples starting at index "
        f"{idx} are unreadable; giving up") from last_err


class FlowDataset:
    """Base dataset (reference ``core/datasets.py:23-105``).

    ``__getitem__`` returns NHWC float32 numpy:
      training: ``(img1, img2, flow, valid)``;
      test mode: ``(img1, img2, extra_info)``.
    """

    def __init__(self, aug_params=None, sparse: bool = False,
                 seed: Optional[int] = None):
        self.augmentor = None
        self.sparse = sparse
        if aug_params is not None:
            cls = SparseFlowAugmentor if sparse else FlowAugmentor
            self.augmentor = cls(seed=seed, **aug_params)
        self.is_test = False
        self.init_seed = seed is not None
        self.flow_list: List[str] = []
        self.image_list: List[Tuple[str, str]] = []
        self.extra_info: List = []

    def __getitem__(self, index):
        if self.is_test:
            img1 = frame_utils.read_gen(self.image_list[index][0])
            img2 = frame_utils.read_gen(self.image_list[index][1])
            img1 = np.asarray(img1).astype(np.float32)[..., :3]
            img2 = np.asarray(img2).astype(np.float32)[..., :3]
            return img1, img2, self.extra_info[index]

        index = index % len(self.image_list)
        valid = None
        if self.sparse:
            flow, valid = frame_utils.read_flow_kitti(self.flow_list[index])
        else:
            flow = frame_utils.read_gen(self.flow_list[index])

        img1 = np.asarray(frame_utils.read_gen(self.image_list[index][0]))
        img2 = np.asarray(frame_utils.read_gen(self.image_list[index][1]))
        flow = np.asarray(flow).astype(np.float32)

        # grayscale → 3 channels (reference :75-77)
        if img1.ndim == 2:
            img1 = np.tile(img1[..., None], (1, 1, 3))
            img2 = np.tile(img2[..., None], (1, 1, 3))
        else:
            img1 = img1[..., :3]
            img2 = img2[..., :3]
        img1 = img1.astype(np.float32)
        img2 = img2.astype(np.float32)

        if self.augmentor is not None:
            if self.sparse:
                img1, img2, flow, valid = self.augmentor(
                    img1, img2, flow, valid)
            else:
                img1, img2, flow = self.augmentor(img1, img2, flow)

        if valid is None:
            valid = ((np.abs(flow[..., 0]) < 1000)
                     & (np.abs(flow[..., 1]) < 1000))   # reference :94-97
        return (img1, img2, flow, valid.astype(np.float32))

    def __rmul__(self, v: int) -> "FlowDataset":
        """Replicate for mixture weighting (reference ``:99-102``)."""
        import copy

        out = copy.copy(self)
        out.flow_list = v * self.flow_list
        out.image_list = v * self.image_list
        out.extra_info = v * self.extra_info
        return out

    def reseed(self, seed) -> None:
        """Reseed the augmentation stream(s). Used by the process-pool
        loader: forked workers inherit identical ``Generator`` states, so
        each worker reseeds with its own (seed, epoch, worker_id) tuple
        to decorrelate augmentation across workers."""
        if self.augmentor is not None:
            self.augmentor.rng = np.random.default_rng(seed)

    def __add__(self, other: "FlowDataset") -> "FlowDataset":
        return _ConcatDataset([self, other])

    def __len__(self):
        return len(self.image_list)


class _ConcatDataset(FlowDataset):
    """Concatenation preserving each source's read path/augmentor
    (torch ``ConcatDataset`` equivalent)."""

    def __init__(self, parts: Sequence[FlowDataset]):
        super().__init__()
        self.parts = []
        for p in parts:
            if isinstance(p, _ConcatDataset):
                self.parts.extend(p.parts)
            else:
                self.parts.append(p)

    def __len__(self):
        return sum(len(p) for p in self.parts)

    def __getitem__(self, index):
        for p in self.parts:
            if index < len(p):
                return p[index]
            index -= len(p)
        raise IndexError(index)

    def __add__(self, other):
        return _ConcatDataset(self.parts + [other])

    def reseed(self, seed) -> None:
        for i, p in enumerate(self.parts):
            p.reseed((*seed, i) if isinstance(seed, tuple) else (seed, i))

    def __rmul__(self, v):
        return _ConcatDataset(v * list(self.parts))


class MpiSintel(FlowDataset):
    """reference ``core/datasets.py:108-124``.

    ``occlusion=True`` additionally indexes the standard Sintel
    ``occlusions/`` masks; read one with :meth:`read_occlusion`. (The
    reference's ``evaluate.py:157`` requests this from a dataset that no
    longer supports it — fork drift; here it is a real feature.)
    """

    def __init__(self, aug_params=None, split="training", root=None,
                 dstype="clean", occlusion: bool = False, seed=None):
        super().__init__(aug_params, seed=seed)
        root = root or os.environ.get("RAFT_DATASETS",
                                      "datasets") + "/Sintel"
        flow_root = osp.join(root, split, "flow")
        occ_root = osp.join(root, split, "occlusions")
        image_root = osp.join(root, split, dstype)
        if split == "test":
            self.is_test = True
        self.occ_list: List[str] = []
        for scene in sorted(os.listdir(image_root)) if osp.isdir(
                image_root) else []:
            image_list = sorted(glob(osp.join(image_root, scene, "*.png")))
            for i in range(len(image_list) - 1):
                self.image_list.append((image_list[i], image_list[i + 1]))
                self.extra_info.append((scene, i))
            if split != "test":
                self.flow_list.extend(sorted(
                    glob(osp.join(flow_root, scene, "*.flo"))))
                if occlusion:
                    self.occ_list.extend(sorted(
                        glob(osp.join(occ_root, scene, "*.png"))))

    def read_occlusion(self, index: int) -> np.ndarray:
        """Boolean (H, W) occlusion mask for sample ``index``."""
        occ = np.asarray(frame_utils.read_gen(self.occ_list[index]))
        return occ > 128


class FlyingChairs(FlowDataset):
    """reference ``core/datasets.py:127-140``; split from chairs_split.txt."""

    def __init__(self, aug_params=None, split="training", root=None,
                 split_file=None, seed=None):
        super().__init__(aug_params, seed=seed)
        root = root or os.environ.get("RAFT_DATASETS",
                                      "datasets") + "/FlyingChairs_release"
        images = sorted(glob(osp.join(root, "data", "*.ppm")))
        flows = sorted(glob(osp.join(root, "data", "*.flo")))
        assert len(images) // 2 == len(flows)

        # The canonical train/val split (22,872 1/2 labels, reference
        # ``chairs_split.txt`` consumed at ``core/datasets.py:135-140``),
        # shipped as a compressed npz; a plain text file of labels is also
        # accepted via ``split_file``.
        if split_file is None:
            split_file = osp.join(osp.dirname(__file__), "chairs_split.npz")
        if split_file.endswith(".npz"):
            split_list = np.load(split_file)["split"]
        else:
            split_list = np.loadtxt(split_file, dtype=np.int32)
        for i in range(len(flows)):
            xid = split_list[i]
            if (split == "training" and xid == 1) or \
               (split == "validation" and xid == 2):
                self.flow_list.append(flows[i])
                self.image_list.append((images[2 * i], images[2 * i + 1]))


class FlyingThings3D(FlowDataset):
    """reference ``core/datasets.py:143-164``: left camera, both time
    directions."""

    def __init__(self, aug_params=None, root=None, dstype="frames_cleanpass",
                 seed=None):
        super().__init__(aug_params, seed=seed)
        root = root or os.environ.get("RAFT_DATASETS",
                                      "datasets") + "/FlyingThings3D"
        for cam in ["left"]:
            for direction in ["into_future", "into_past"]:
                image_dirs = sorted(glob(osp.join(root, dstype, "TRAIN/*/*")))
                image_dirs = sorted([osp.join(f, cam) for f in image_dirs])
                flow_dirs = sorted(glob(osp.join(
                    root, "optical_flow/TRAIN/*/*")))
                flow_dirs = sorted([osp.join(f, direction, cam)
                                    for f in flow_dirs])
                for idir, fdir in zip(image_dirs, flow_dirs):
                    images = sorted(glob(osp.join(idir, "*.png")))
                    flows = sorted(glob(osp.join(fdir, "*.pfm")))
                    for i in range(len(flows) - 1):
                        if direction == "into_future":
                            self.image_list.append(
                                (images[i], images[i + 1]))
                            self.flow_list.append(flows[i])
                        else:
                            self.image_list.append(
                                (images[i + 1], images[i]))
                            self.flow_list.append(flows[i + 1])


class KITTI(FlowDataset):
    """reference ``core/datasets.py:167-183`` (sparse)."""

    def __init__(self, aug_params=None, split="training", root=None,
                 seed=None):
        super().__init__(aug_params, sparse=True, seed=seed)
        root = root or os.environ.get("RAFT_DATASETS",
                                      "datasets") + "/KITTI"
        if split == "testing":
            self.is_test = True
        root = osp.join(root, split)
        images1 = sorted(glob(osp.join(root, "image_2/*_10.png")))
        images2 = sorted(glob(osp.join(root, "image_2/*_11.png")))
        for img1, img2 in zip(images1, images2):
            frame_id = img1.split("/")[-1]
            self.extra_info.append([frame_id])
            self.image_list.append((img1, img2))
        if split == "training":
            self.flow_list = sorted(glob(osp.join(root, "flow_occ/*_10.png")))


class HD1K(FlowDataset):
    """reference ``core/datasets.py:186-202`` (sparse)."""

    def __init__(self, aug_params=None, root=None, seed=None):
        super().__init__(aug_params, sparse=True, seed=seed)
        root = root or os.environ.get("RAFT_DATASETS",
                                      "datasets") + "/HD1k"
        seq_ix = 0
        while True:
            flows = sorted(glob(osp.join(
                root, "hd1k_flow_gt",
                "flow_occ/%06d_*.png" % seq_ix)))
            images = sorted(glob(osp.join(
                root, "hd1k_input", "image_2/%06d_*.png" % seq_ix)))
            if len(flows) == 0:
                break
            for i in range(len(flows) - 1):
                self.flow_list.append(flows[i])
                self.image_list.append((images[i], images[i + 1]))
            seq_ix += 1


@dataclasses.dataclass
class LoaderState:
    """Serializable input-pipeline state — the unit the checkpoint layer
    saves inside each commit-gated step directory.

    ``seed``/``epoch`` pin the deterministic permutation
    (``default_rng(seed + epoch)``); ``pos`` is the sample cursor within
    that permutation, counted in *yielded-to-the-consumer* samples (a
    multiple of the batch size — prefetched-but-unyielded batches are
    not consumed). The resilience counters ride along so a resumed
    run's degradation totals continue instead of resetting to zero.
    """

    seed: int
    epoch: int
    pos: int
    substituted_samples: int = 0
    sample_retries: int = 0
    worker_timeouts: int = 0

    def to_dict(self) -> dict:
        return {k: int(v) for k, v in dataclasses.asdict(self).items()}

    @classmethod
    def from_dict(cls, d: dict) -> "LoaderState":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            print(f"WARNING: ignoring unknown loader-state fields "
                  f"{sorted(unknown)} (newer writer?)", flush=True)
        return cls(**{k: int(v) for k, v in d.items() if k in known})


class DataLoader:
    """Thread-pool prefetching batch loader.

    Replaces torch ``DataLoader(num_workers=24, pin_memory, drop_last)``
    (reference ``core/datasets.py:236-237``): worker threads read+augment
    samples ahead of the train loop; batches are stacked NHWC numpy dicts.

    One ``__iter__`` pass yields the *remainder* of the current epoch
    from the cursor (the whole epoch on a fresh or epoch-aligned
    loader); exhausting it advances ``epoch`` and resets the cursor, so
    ``while True: for batch in loader`` walks epochs exactly as before.
    Breaking out mid-epoch leaves the cursor at the last yielded batch
    — :meth:`state` then names the exact next sample to be produced.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, drop_last: bool = True,
                 seed: int = 0, prefetch: int = 2,
                 stall_timeout: Optional[float] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 1)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0
        # Sample cursor within the current epoch's permutation: counts
        # samples YIELDED to the consumer (always a multiple of
        # batch_size), never samples merely submitted to the pump.
        self._pos = 0
        # Bumped by load_state(): a live iterator from before the
        # restore notices at its next batch boundary and drains instead
        # of yielding stale pre-restore batches.
        self._generation = 0
        # Degradation counters for this loader (substituted samples);
        # the train loop streams them to the scalar sinks.
        self.stats = ResilienceStats()
        # Stall watchdog period (seconds; 0 disables). A pump that stops
        # producing — hung NFS, deadlocked worker — gets a diagnostic
        # instead of a silently wedged run.
        if stall_timeout is None:
            stall_timeout = float(
                os.environ.get("RAFT_LOADER_STALL_TIMEOUT", "300"))
        self.stall_timeout = stall_timeout

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    # -- checkpointable state --------------------------------------------

    def state(self) -> LoaderState:
        """Snapshot of the input-pipeline cursor + resilience counters.

        Call it when the *consumer* is at a quiescent point (the train
        loop snapshots right after each optimizer step): ``pos`` then
        equals the samples actually trained on, regardless of how far
        ahead the prefetch pump has filled.
        """
        return LoaderState(
            seed=int(self.seed), epoch=int(self.epoch),
            pos=int(self._pos),
            substituted_samples=int(self.stats.substituted_samples),
            sample_retries=int(self.stats.sample_retries),
            worker_timeouts=int(self.stats.worker_timeouts))

    def load_state(self, state) -> None:
        """Restore a :meth:`state` snapshot (``LoaderState`` or its
        ``to_dict`` form). The next iteration resumes at exactly the
        restored cursor; an iterator already in flight drains at its
        next batch boundary (its pending prefetch futures are abandoned)
        instead of yielding pre-restore batches.
        """
        if isinstance(state, dict):
            state = LoaderState.from_dict(state)
        if state.pos % self.batch_size:
            raise ValueError(
                f"loader cursor {state.pos} is not a multiple of "
                f"batch_size={self.batch_size} — state saved by an "
                f"incompatible run configuration")
        self.seed = int(state.seed)
        self.epoch = int(state.epoch)
        self._pos = int(state.pos)
        self.stats.substituted_samples = int(state.substituted_samples)
        self.stats.sample_retries = int(state.sample_retries)
        self.stats.worker_timeouts = int(state.worker_timeouts)
        self._generation += 1   # drain any in-flight pump

    def _batches(self, order):
        bs = self.batch_size
        stop = len(order) - (len(order) % bs if self.drop_last else 0)
        for i in range(0, stop, bs):
            yield order[i:i + bs]

    def _epoch_order(self, epoch: int):
        """The deterministic permutation for ``epoch`` — a pure function
        of (seed, epoch), so a restored cursor indexes the identical
        order the interrupted run was consuming."""
        rng = np.random.default_rng(self.seed + epoch)
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(order)
        return order

    def _prefetch_loop(self, order, submit, result, start: int, gen: int):
        """Shared pump for both loader kinds: keep ``prefetch`` batches
        of per-sample futures in flight via ``submit(idx)``, drain in
        order via ``result(fut, sample_idx, batch_no)``, yield stacked
        NHWC batch dicts starting at sample cursor ``start``.

        ``result(...)`` resolves to ``(sample, n_substituted,
        n_retried)`` (see :func:`_read_sample`); both counters are
        accumulated into ``self.stats``. ``self._pos`` advances to the
        end of each batch immediately before it is yielded, and a
        ``load_state`` during iteration (generation mismatch against
        ``gen``) drains the pump at the next batch boundary. A
        :class:`StallWatchdog` (``stall_timeout`` > 0) is petted per
        yielded batch and prints a pump diagnostic when production
        stops.
        """
        batches = list(self._batches(order))
        skip = start // self.batch_size
        pending = []
        k = skip
        yielded = 0

        def _diagnose():
            return (f"{yielded}/{len(batches) - skip} batches yielded "
                    f"(epoch cursor {skip}+), "
                    f"{len(pending)} batch(es) of futures in flight, "
                    f"{self.num_workers} workers "
                    f"({type(self).__name__})")

        watchdog = (StallWatchdog(self.stall_timeout, _diagnose)
                    if self.stall_timeout and self.stall_timeout > 0
                    else None)
        try:
            if watchdog is not None:
                watchdog.pet()
            while k < len(batches) or pending:
                if self._generation != gen:
                    return          # restored mid-flight: drain the pump
                while k < len(batches) and len(pending) < self.prefetch:
                    pending.append(
                        (k, [(int(i), submit(i)) for i in batches[k]]))
                    k += 1
                batch_no, futures = pending.pop(0)
                samples = []
                for idx, f in futures:
                    sample, subs, retries = result(f, idx, batch_no)
                    if subs:
                        self.stats.count_substitution(subs)
                    if retries:
                        self.stats.count_sample_retries(retries)
                    samples.append(sample)
                batch = {
                    "image1": np.stack([s[0] for s in samples]),
                    "image2": np.stack([s[1] for s in samples]),
                    "flow": np.stack([s[2] for s in samples]),
                    "valid": np.stack([s[3] for s in samples]),
                }
                # Cursor advances with the handoff: once the consumer
                # holds this batch, state() reports it consumed.
                self._pos = (batch_no + 1) * self.batch_size
                yield batch
                yielded += 1
                if watchdog is not None:
                    watchdog.pet()
        finally:
            if watchdog is not None:
                watchdog.close()

    def __iter__(self):
        from concurrent.futures import ThreadPoolExecutor

        gen = self._generation
        epoch = self.epoch
        order = self._epoch_order(epoch)

        def load(idx):
            return _read_sample(self.dataset, int(idx))

        with ThreadPoolExecutor(self.num_workers) as pool:
            yield from self._prefetch_loop(
                order, lambda i: pool.submit(load, i),
                lambda f, idx, batch_no: f.result(),
                start=self._pos, gen=gen)
        # Reached only on full exhaustion (a consumer break skips this,
        # leaving the cursor mid-epoch; a load_state drain skips the
        # advance via the generation check).
        if self._generation == gen:
            self.epoch, self._pos = epoch + 1, 0


# Worker-process globals: set once per worker by the pool initializer
# (the dataset is pickled once per worker at pool start — file lists +
# augmentor params, a few hundred KB — never per task). The pool is
# created ONCE per loader and reused across epochs, so the augmentation
# stream is reseeded lazily per task when the epoch changes, not at
# init.
_WORKER_DS = None
_WORKER_WID = None
_WORKER_STREAM = None     # (seed, epoch) the dataset is currently seeded for
_WORKER_CLAIMS = None     # shared array: claims[wid] = sample idx in flight


def _process_worker_init(dataset, counter, claims):
    global _WORKER_DS, _WORKER_WID, _WORKER_STREAM, _WORKER_CLAIMS
    with counter.get_lock():
        _WORKER_WID = counter.value
        counter.value += 1
    _WORKER_DS = dataset
    _WORKER_STREAM = None
    _WORKER_CLAIMS = claims


def _process_worker_load(idx, seed, epoch):
    # Same fault-tolerant read path as the thread loader; the
    # substitution/retry counts ride back to the parent in the result
    # tuple (workers are separate processes — parent-side counters
    # can't see their recoveries otherwise). The (seed, epoch) ride
    # with every task so the long-lived worker reseeds itself on the
    # first task of each new epoch — same (seed, epoch, worker_id)
    # streams as the old fork-per-epoch design, without paying a pool
    # restart.
    global _WORKER_STREAM
    if _WORKER_STREAM != (seed, epoch):
        _WORKER_DS.reseed((seed, epoch, _WORKER_WID))
        _WORKER_STREAM = (seed, epoch)
    # Claim the sample in the shared array so the parent can name this
    # worker if it dies mid-read (the claim survives the death; the
    # result never arrives). Cleared on every normal return.
    if _WORKER_CLAIMS is not None:
        _WORKER_CLAIMS[_WORKER_WID] = int(idx)
    try:
        (i1, i2, fl, v), subs, retries = _read_sample(_WORKER_DS, int(idx))
        return (i1, i2, fl, v), subs, retries
    finally:
        if _WORKER_CLAIMS is not None:
            _WORKER_CLAIMS[_WORKER_WID] = -1


class ProcessDataLoader(DataLoader):
    """Worker-*process* prefetching batch loader, the analogue of torch
    ``DataLoader(num_workers=24)`` (reference ``core/datasets.py:237``).

    The thread loader overlaps file IO and the GIL-releasing C++
    augmentation, but the numpy parts of each sample (decode to float32,
    batch stacking) hold the GIL. On hosts of several cores worker
    processes are the scaling path: each worker owns an interpreter,
    samples come back through a pipe as numpy pickles, and the parent only
    stacks batches.

    Workers come from a ``forkserver`` context, not plain ``fork``: by the
    first batch the parent has initialised torch and the CUDA runtime (the
    model precedes the loader), so it is multi-threaded, and forking it can
    inherit a lock mid-acquisition and deadlock the child. The fork server
    is a clean single-threaded process started at first use; workers fork
    from it and import this module's numpy world only, never torch. Each
    worker reseeds its augmentation stream with (seed, epoch, worker_id)
    so that workers do not produce identical crops, lazily on the first
    task of each epoch, because one pool serves every epoch.

    Results are drained with a timeout (``worker_timeout`` seconds, or
    ``RAFT_LOADER_WORKER_TIMEOUT``, default 300): a worker that dies
    without returning (the OOM killer) surfaces as a ``RuntimeError``
    naming the wait, not a permanent hang.
    """

    def __init__(self, *args, worker_timeout: Optional[float] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        if worker_timeout is None:
            worker_timeout = float(
                os.environ.get("RAFT_LOADER_WORKER_TIMEOUT", "300"))
        self.worker_timeout = worker_timeout
        self._pool = None
        self._claims = None

    def _ensure_pool(self):
        import multiprocessing as mp
        import weakref

        if self._pool is None:
            ctx = mp.get_context("forkserver")
            counter = ctx.Value("i", 0)
            # claims[wid] = sample index that worker is reading right
            # now (-1 idle): lets a timed-out drain name the worker
            # that died holding the sample instead of just the wait.
            self._claims = ctx.Array("l", [-1] * self.num_workers)
            self._pool = ctx.Pool(
                self.num_workers, initializer=_process_worker_init,
                initargs=(self.dataset, counter, self._claims))
            # GC-time cleanup that must not resurrect self: capture the
            # pool, not the loader.
            pool = self._pool
            weakref.finalize(self, lambda p: (p.terminate(), p.join()),
                             pool)
        return self._pool

    def close(self):
        """Terminate the worker pool (idempotent; the next iteration
        would start a fresh one)."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def _get_result(self, fut, sample_idx, batch_no):
        from multiprocessing import TimeoutError as MpTimeout

        try:
            return fut.get(self.worker_timeout)
        except MpTimeout:
            self.stats.count_worker_timeout()
            # Name the culprit: the claims array records which worker
            # was holding this sample when it stopped responding.
            wid = "unknown"
            if self._claims is not None:
                holders = [w for w, idx in enumerate(self._claims)
                           if idx == sample_idx]
                if holders:
                    wid = ", ".join(str(w) for w in holders)
            raise RuntimeError(
                f"loader worker {wid} produced no result for sample "
                f"{sample_idx} (batch {batch_no}) within "
                f"{self.worker_timeout:.0f}s — the worker process "
                "likely died without returning (OOM-killed?); check "
                "dmesg, lower num_workers, or raise "
                "RAFT_LOADER_WORKER_TIMEOUT") from None

    def __iter__(self):
        gen = self._generation
        epoch = self.epoch
        order = self._epoch_order(epoch)
        pool = self._ensure_pool()
        yield from self._prefetch_loop(
            order,
            lambda i: pool.apply_async(_process_worker_load,
                                       (i, self.seed, epoch)),
            self._get_result,
            start=self._pos, gen=gen)
        if self._generation == gen:
            self.epoch, self._pos = epoch + 1, 0


def select_loader(loader: str = "auto",
                  num_workers: Optional[int] = None):
    """Resolve the input-pipeline kind and worker count for this host.

    ``loader``: ``"thread"`` (the GIL-sharing prefetcher, right for hosts
    of one or two cores, where moving samples between processes only
    costs), ``"process"`` (worker processes from a forkserver, the torch
    ``num_workers=24`` analogue), or ``"auto"`` (processes on four or more
    cores). ``num_workers=None`` sizes the pool to the host: a worker a
    core, at most 24 (the reference's setting) and at least 4. Returns
    ``(loader_cls, num_workers)``."""
    if loader not in ("auto", "thread", "process"):
        raise ValueError(f"loader must be auto|thread|process: {loader!r}")
    cores = os.cpu_count() or 1
    if loader == "auto":
        loader = "process" if cores >= 4 else "thread"
    if num_workers is None:
        num_workers = max(4, min(cores, 24))
    cls = ProcessDataLoader if loader == "process" else DataLoader
    return cls, num_workers


def fetch_dataloader(stage: str, batch_size: int,
                     image_size: Tuple[int, int],
                     num_workers: Optional[int] = None, seed: int = 0,
                     root: Optional[str] = None,
                     loader: str = "auto") -> DataLoader:
    """Stage-specific dataset mixtures (reference
    ``core/datasets.py:205-240``) as a loader: ``chairs``, ``things``,
    ``sintel`` (the C+T+K+S+H mixture) or ``kitti``. ``root``: the directory that holds ``FlyingChairs_release``,
    ``FlyingThings3D``, ``Sintel``, ``KITTI`` and ``HD1k`` (None:
    ``$RAFT_DATASETS``, else ``datasets``). ``loader``/``num_workers``:
    see :func:`select_loader`."""
    cls, num_workers = select_loader(loader, num_workers)

    def under(name):
        return root and osp.join(root, name)

    crop = {"crop_size": image_size}
    if stage == "chairs":
        aug = dict(crop, min_scale=-0.1, max_scale=1.0, do_flip=True)
        train_dataset = FlyingChairs(aug, split="training",
                                     root=under("FlyingChairs_release"),
                                     seed=seed)
    elif stage == "things":
        aug = dict(crop, min_scale=-0.4, max_scale=0.8, do_flip=True)
        clean = FlyingThings3D(aug, root=under("FlyingThings3D"),
                               dstype="frames_cleanpass", seed=seed)
        final = FlyingThings3D(aug, root=under("FlyingThings3D"),
                               dstype="frames_finalpass", seed=seed)
        train_dataset = clean + final
    elif stage == "sintel":
        aug = dict(crop, min_scale=-0.2, max_scale=0.6, do_flip=True)
        things = FlyingThings3D(dict(aug, max_scale=0.8),
                                root=under("FlyingThings3D"),
                                dstype="frames_cleanpass", seed=seed)
        sintel_clean = MpiSintel(aug, split="training", root=under("Sintel"),
                                 dstype="clean", seed=seed)
        sintel_final = MpiSintel(aug, split="training", root=under("Sintel"),
                                 dstype="final", seed=seed)
        # the reference's C+T+K+S+H mixture (:218-230)
        kitti = KITTI(dict(crop, min_scale=-0.3, max_scale=0.5,
                           do_flip=True), root=under("KITTI"), seed=seed)
        hd1k = HD1K(dict(crop, min_scale=-0.5, max_scale=0.2,
                         do_flip=True), root=under("HD1k"), seed=seed)
        train_dataset = (100 * sintel_clean + 100 * sintel_final
                         + 200 * kitti + 5 * hd1k + things)
    elif stage == "kitti":
        aug = dict(crop, min_scale=-0.2, max_scale=0.4, do_flip=False)
        train_dataset = KITTI(aug, split="training", root=under("KITTI"),
                              seed=seed)
    else:
        raise ValueError(f"unknown stage {stage!r}")

    return cls(train_dataset, batch_size=batch_size, shuffle=True,
               num_workers=num_workers, drop_last=True, seed=seed)
