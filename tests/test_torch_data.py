"""The port's data pipeline against the JAX package's, on the CPU.

``raft_tpu_torch.data`` (``frame_utils``, ``augmentor``, ``datasets``),
``raft_tpu_torch.native`` and ``raft_tpu_torch.resilience`` are copies of
the JAX package's framework-free modules; these tests hold them to it bit
for bit on the same inputs and seeds: the file formats both ways, the
augmentors on each backend this machine has (forced the same way in both
packages), and ``fetch_dataloader``'s batches for every stage on small
synthetic dataset trees (``raft_tpu_torch.data.synthetic``). Then the
port's loaders alone: the process loader against the thread loader (its
workers import no torch), a ``LoaderState`` restored mid-epoch, an
unreadable sample retried and substituted (as in the JAX package), and
the native library's build directory. Nothing here compiles a JAX program.

    python -m pytest tests/test_torch_data.py -q
"""

import os
import sys

import numpy as np
import pytest
from PIL import Image

from raft_tpu import native as jax_native
from raft_tpu.data import augmentor as jax_augmentor
from raft_tpu.data import datasets as jax_datasets
from raft_tpu.data import frame_utils as jax_frame_utils
from raft_tpu_torch import native
from raft_tpu_torch.data import augmentor, datasets, frame_utils, synthetic
from raft_tpu_torch.ops.build import BUILD_DIR

PAIRS, HW, CROP, BATCH = 8, (96, 128), (64, 96), 2


def _equal(a, b):
    """Nested batches, samples or arrays equal bit for bit (NaN too)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def backend(request, monkeypatch):
    """Force one augmentation backend in both packages: ``native`` (the
    host library for float32 resizes and colour jitter, cv2 for the hue)
    or ``cv2`` (the library off in both)."""
    if request.param == "native":
        if not (native.available() and jax_native.available()):
            pytest.skip("the native library does not build here")
    else:
        for mod in (native, jax_native):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_tried", True)
    assert augmentor._HAS_CV2 and jax_augmentor._HAS_CV2
    return request.param


@pytest.mark.parametrize("fmt", ["flo", "pfm", "kitti", "ppm"])
def test_frame_utils_round_trips_against_jax(tmp_path, fmt):
    """Each format written by one package reads back equal through the
    other's reader and ``read_gen``: ``.flo``, ``.pfm`` (one and three
    channels), KITTI's 16-bit PNG flow and ``.ppm`` frames."""
    rng = np.random.default_rng(0)
    flow = (20 * rng.standard_normal((9, 13, 2))).astype(np.float32)
    for writer, reader, tag in ((frame_utils, jax_frame_utils, "port"),
                                (jax_frame_utils, frame_utils, "jax")):
        path = str(tmp_path / f"{tag}.{'png' if fmt == 'kitti' else fmt}")
        if fmt == "flo":
            writer.write_flo(path, flow)
            _equal(reader.read_flo(path), flow)
            _equal(reader.read_gen(path), frame_utils.read_gen(path))
        elif fmt == "pfm":
            for image in (flow[..., 0], np.concatenate(
                    [flow, flow[..., :1]], -1)):
                writer.write_pfm(path, image, scale=2.0)
                data, scale = reader.read_pfm(path)
                assert scale == 2.0
                _equal(np.ascontiguousarray(data), image)
                _equal(reader.read_gen(path), frame_utils.read_gen(path))
        elif fmt == "kitti":
            writer.write_flow_kitti(path, flow)
            got, valid = reader.read_flow_kitti(path)
            want, want_valid = frame_utils.read_flow_kitti(path)
            _equal((got, valid), (want, want_valid))
            # the writer truncates to 1/64 px
            assert np.abs(got - flow).max() <= 1 / 64 and valid.all()
        else:
            image = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
            Image.fromarray(image).save(path)
            _equal(np.asarray(reader.read_gen(path)), image)
            _equal(np.asarray(frame_utils.read_gen(path)),
                   np.asarray(jax_frame_utils.read_gen(path)))


@pytest.mark.parametrize("backend", ["native", "cv2"], indirect=True)
def test_augmentors_match_jax_bit_for_bit(backend):
    """``ColorJitter``, ``FlowAugmentor`` and ``SparseFlowAugmentor`` from
    the same seed on the same frames give the JAX package's outputs bit for
    bit, over enough draws to take every branch (asymmetric jitter, the
    eraser, stretch, the no-resize floor, both flips)."""
    assert augmentor.backends()["resize"] == backend
    rng = np.random.default_rng(3)
    img1 = rng.integers(0, 256, (*HW, 3)).astype(np.float32)
    img2 = np.roll(img1, (2, -3), (0, 1))
    flow = rng.standard_normal((*HW, 2)).astype(np.float32)
    valid = (rng.uniform(size=HW) > 0.3).astype(np.float32)
    jitter = (augmentor.ColorJitter(), jax_augmentor.ColorJitter())
    gens = (np.random.default_rng(5), np.random.default_rng(5))
    for _ in range(4):
        _equal(*(j(img1, g) for j, g in zip(jitter, gens)))
    dense = [m.FlowAugmentor(CROP, seed=7)
             for m in (augmentor, jax_augmentor)]
    sparse = [m.SparseFlowAugmentor(CROP, seed=7)
              for m in (augmentor, jax_augmentor)]
    for _ in range(6):
        _equal(*(a(img1.copy(), img2.copy(), flow.copy()) for a in dense))
        _equal(*(a(img1.copy(), img2.copy(), flow.copy(), valid.copy())
                 for a in sparse))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One synthetic tree a stage: ``PAIRS`` pairs of ``HW`` in each of
    its datasets."""
    return {stage: synthetic.write_tree(str(tmp_path_factory.mktemp(stage)),
                                        stage, PAIRS, HW, seed=1)
            for stage in synthetic.STAGE_WRITERS}


@pytest.mark.parametrize("stage", ["chairs", "things", "sintel", "kitti"])
def test_fetch_dataloader_matches_jax_bit_for_bit(trees, stage, monkeypatch):
    """``fetch_dataloader(stage)`` of both packages over the same tree and
    seed (the thread loader, one worker, so that the augmentation draws
    come in order): the same batches, bit for bit. The JAX package reads
    the datasets other than FlyingChairs under ``$RAFT_DATASETS``."""
    root = trees[stage]
    monkeypatch.setenv("RAFT_DATASETS", root)
    loaders = [m.fetch_dataloader(stage, BATCH, CROP, seed=4, root=root,
                                  loader="thread", num_workers=1)
               for m in (datasets, jax_datasets)]
    assert len(loaders[0]) == len(loaders[1]) >= 2
    for n, (got, want) in enumerate(zip(*loaders)):
        assert got["image1"].shape == (BATCH, *CROP, 3)
        _equal(got, want)
        if n == 1:
            break
    assert loaders[0].state() == datasets.LoaderState(4, 0, 2 * BATCH)


def _plain_chairs(root):
    """FlyingChairs under ``root`` with no augmentation: the frames and
    flows as read, so that every loader's batches are comparable."""
    return datasets.FlyingChairs(None, root=os.path.join(
        root, "FlyingChairs_release"))


def test_process_loader_matches_thread_loader(trees):
    """Two forkserver workers give the thread loader's batches in its
    order, and their interpreters import neither torch nor JAX."""
    data = _plain_chairs(trees["chairs"])
    threads = datasets.DataLoader(data, BATCH, num_workers=2, seed=9)
    procs = datasets.ProcessDataLoader(data, BATCH, num_workers=2, seed=9)
    try:
        got = list(procs)
        _equal(got, list(threads))
        assert len(got) == len(data) // BATCH
        assert procs.state() == threads.state() == datasets.LoaderState(
            9, 1, 0)
        heavy = procs._ensure_pool().apply(eval, (
            "sorted({m.split('.')[0] for m in __import__('sys').modules}"
            " & {'torch', 'jax', 'raft_tpu'})",))
        assert heavy == []
    finally:
        procs.close()


def test_loader_state_resumes_at_the_same_sample(trees):
    """A ``LoaderState`` taken after two batches and restored (through its
    dict form) into a new loader: the next batches are the uninterrupted
    run's third and later; a cursor that is no multiple of the batch size
    is refused."""
    data = _plain_chairs(trees["chairs"])
    whole = list(datasets.DataLoader(data, BATCH, num_workers=1, seed=2))
    first = datasets.DataLoader(data, BATCH, num_workers=1, seed=2)
    it = iter(first)
    for _ in range(2):
        next(it)
    saved = first.state().to_dict()
    assert saved["pos"] == 2 * BATCH and saved["epoch"] == 0
    again = datasets.DataLoader(data, BATCH, num_workers=1, seed=0)
    again.load_state(saved)
    _equal(list(again), whole[2:])
    assert again.epoch == 1
    with pytest.raises(ValueError, match="multiple"):
        again.load_state(dict(saved, pos=BATCH + 1))


def test_unreadable_sample_is_retried_then_substituted(trees):
    """A sample whose reads fail (an injected fault) is retried twice, then
    replaced by the next index, in both packages alike; the loader's
    counters and its state carry the substitution and the retries."""
    from raft_tpu import resilience as jax_resilience
    from raft_tpu_torch import resilience

    root = os.path.join(trees["chairs"], "FlyingChairs_release")
    batches, loaders = [], []
    for mod, res in ((datasets, resilience), (jax_datasets, jax_resilience)):
        prev = res.set_injector(res.FaultInjector(
            corrupt_sample_indices=frozenset({1})))
        try:
            loader = mod.DataLoader(mod.FlyingChairs(None, root=root), BATCH,
                                    shuffle=False, num_workers=1)
            batches.append(next(iter(loader)))
            loaders.append(loader)
        finally:
            res.set_injector(prev)
        assert (loader.stats.substituted_samples,
                loader.stats.sample_retries) == (1, 2)
    _equal(*batches)
    want = _plain_chairs(trees["chairs"])[2]
    _equal([batches[0][k][1] for k in ("image1", "image2", "flow",
                                       "valid")], want)
    assert loaders[0].state().substituted_samples == 1


def test_native_library_builds_into_the_ports_build_dir():
    """``augment.cpp`` builds with g++ into ``build/raft_tpu_torch/``
    (named by the source's hash), not into the JAX package's cache, and
    its resize equals the JAX package's library's."""
    from raft_tpu_torch.native import build

    path = build.build()
    assert os.path.dirname(path) == BUILD_DIR and os.path.isfile(path)
    assert path == build.lib_path() and native.available()
    assert "raft_tpu_torch" in sys.modules and ".cache" not in path
    img = np.random.default_rng(1).uniform(0, 255, (17, 23, 3)).astype(
        np.float32)
    want = (jax_native.resize_bilinear(img, 30, 41, fx=41 / 23, fy=30 / 17)
            if jax_native.available() else None)
    got = native.resize_bilinear(img, 30, 41, fx=41 / 23, fy=30 / 17)
    assert got.shape == (30, 41, 3)
    if want is not None:
        _equal(got, want)
