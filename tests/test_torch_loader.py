"""The port's token loader vs the JAX package's, bit for bit.

Both sample (batch, seq) windows of one uint32 corpus with the xorshift64*
stream. The port's default path is its own copy of the native prefetcher
(built with g++ into ``kubeflow_tpu_torch/_build/``); it and the port's
``force_python`` path are held to the JAX package's native and Python
loaders, with and without a resume ``start_batch``, and through
``sharded_loader`` for two process ids. A source that does not compile
raises naming its build log (the JAX loader would fall back to Python).
"""

from __future__ import annotations

import numpy as np
import pytest

from kubeflow_tpu.data import loader as J
from kubeflow_tpu_torch.data import loader as P
from kubeflow_tpu_torch.ops import _build


@pytest.fixture
def corpus(tmp_path):
    tokens = np.random.default_rng(0).integers(0, 2**32 - 1, size=4099,
                                               dtype=np.uint64)
    return P.write_token_file(tmp_path / "corpus.bin", tokens)


def test_token_file_format_matches(tmp_path):
    tokens = np.arange(10, dtype=np.int64) * 7
    a = P.write_token_file(tmp_path / "a.bin", tokens)
    b = J.write_token_file(tmp_path / "b.bin", tokens)
    assert a.read_bytes() == b.read_bytes() == tokens.astype("<u4").tobytes()


@pytest.mark.parametrize("seed,start_batch", [(1, 0), (7, 0), (1, 5),
                                              (0, 123)])
def test_stream_equals_the_jax_loader(corpus, seed, start_batch):
    ref = J.TokenLoader(corpus, 3, 17, seed=seed, force_python=True,
                        start_batch=start_batch)
    with P.TokenLoader(corpus, 3, 17, seed=seed,
                       start_batch=start_batch) as got:
        for _ in range(6):
            a, b = got.next(), ref.next()
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    ref.close()


def test_resume_skips_exactly_the_consumed_batches(corpus):
    with P.TokenLoader(corpus, 2, 9, seed=3) as full:
        stream = list(full.batches(7))
    with P.TokenLoader(corpus, 2, 9, seed=3, start_batch=4) as resumed:
        for want in stream[4:]:
            np.testing.assert_array_equal(resumed.next(), want)


@pytest.mark.parametrize("pid", [0, 1])
def test_sharded_loader_equals_the_jax_one(corpus, pid):
    ref = J.sharded_loader(corpus, 4, 11, seed=5, process_id=pid,
                           num_processes=2, start_batch=2, force_python=True)
    got = P.sharded_loader(corpus, 4, 11, seed=5, process_id=pid,
                           num_processes=2, start_batch=2)
    assert got.batch == ref.batch == 2
    for _ in range(4):
        np.testing.assert_array_equal(got.next(), ref.next())
    got.close()
    ref.close()


def test_sharded_loader_defaults_to_one_process(corpus):
    got = P.sharded_loader(corpus, 4, 11, seed=5)
    ref = P.sharded_loader(corpus, 4, 11, seed=5, process_id=0,
                           num_processes=1)
    assert got.batch == 4
    np.testing.assert_array_equal(got.next(), ref.next())


def test_refusals(corpus, tmp_path):
    with pytest.raises(FileNotFoundError):
        P.TokenLoader(tmp_path / "missing.bin", 1, 4)
    with pytest.raises(ValueError, match="start_batch"):
        P.TokenLoader(corpus, 1, 4, start_batch=-1)
    with pytest.raises(ValueError, match="tokens < seq"):
        P.TokenLoader(corpus, 1, 5000)
    with pytest.raises(ValueError, match="not divisible"):
        P.sharded_loader(corpus, 3, 4, process_id=0, num_processes=2)
    loader = P.TokenLoader(corpus, 1, 4)
    loader.close()
    with pytest.raises(ValueError, match="closed"):
        loader.next()


def test_native_loader_builds_into_the_build_dir(corpus):
    with P.TokenLoader(corpus, 2, 8) as got:
        assert got.native
    lib = _build.host_library_path(P._SRC)
    assert lib.parent == _build.BUILD_DIR and lib.exists()
    assert P._SRC.parent == _build.HOST_SRC
    assert P._SRC not in _build.sources().values()
    with P.TokenLoader(corpus, 2, 8, force_python=True) as got:
        assert not got.native


@pytest.mark.parametrize("port_python", [False, True],
                         ids=["native", "python"])
@pytest.mark.parametrize("jax_python", [False, True],
                         ids=["jax-native", "jax-python"])
@pytest.mark.parametrize("seed,start_batch", [(1, 0), (0, 0), (9, 3),
                                              (2, 1000)])
def test_both_paths_equal_both_jax_loaders(corpus, port_python, jax_python,
                                           seed, start_batch):
    ref = J.TokenLoader(corpus, 4, 33, seed=seed, force_python=jax_python,
                        start_batch=start_batch, prefetch=2)
    assert ref.native != jax_python
    with P.TokenLoader(corpus, 4, 33, seed=seed, force_python=port_python,
                       start_batch=start_batch, prefetch=2) as got:
        assert got.native != port_python
        for want in ref.batches(5):
            np.testing.assert_array_equal(got.next(), want)
    ref.close()


def test_native_sharded_loader_equals_the_jax_one(corpus):
    for pid in (0, 1):
        ref = J.sharded_loader(corpus, 4, 11, seed=5, process_id=pid,
                               num_processes=2, start_batch=2)
        got = P.sharded_loader(corpus, 4, 11, seed=5, process_id=pid,
                               num_processes=2, start_batch=2, prefetch=1)
        assert got.native
        for _ in range(4):
            np.testing.assert_array_equal(got.next(), ref.next())
        got.close()
        ref.close()


def test_a_broken_build_raises_naming_its_log(corpus, tmp_path, monkeypatch):
    broken = tmp_path / "dataloader.cpp"
    broken.write_text("extern \"C\" int dl_abi_version() { return }\n")
    monkeypatch.setattr(P, "_SRC", broken)
    with pytest.raises(RuntimeError, match=r"g\+\+ exit 1\); see .*\.log"):
        P.TokenLoader(corpus, 1, 4)
    log = _build.host_library_path(broken).with_suffix(".log")
    assert "error" in log.read_text()
    assert not _build.host_library_path(broken).exists()
    # The Python path is still there when asked for by name.
    with P.TokenLoader(corpus, 1, 4, force_python=True) as got:
        assert got.next().shape == (1, 4)


def test_native_loader_closes_once_and_refuses_after(corpus):
    loader = P.TokenLoader(corpus, 2, 8)
    assert loader.next().shape == (2, 8)
    loader.close()
    loader.close()
    with pytest.raises(ValueError, match="closed"):
        loader.next()
