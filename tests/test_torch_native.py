"""The port's bindings of the native host code (cbf_tpu_torch.native,
.native.trajsink) against the JAX package's: both bind the same
native/qp2d.cpp and native/trajsink.cpp, the port building them into its
own directory. The QP solver's outputs must be bit-equal; a trajectory
file written by either package's sink must read back, equal, through the
other's reader. Skipped without a C++ toolchain, as tests/test_native.py
is."""

import numpy as np
import pytest

from cbf_tpu import native as jnat
from cbf_tpu.native import trajsink as jsink
from cbf_tpu_torch import native as tnat
from cbf_tpu_torch.native import trajsink as tsink

pytestmark = pytest.mark.skipif(
    not (tnat.available() and tsink.available()),
    reason="native toolchain unavailable")


def test_builds_into_the_ports_own_directory():
    assert tnat._SO.startswith(tnat._BUILD_DIR)
    assert tsink._SO.startswith(tnat._BUILD_DIR)
    assert tnat._SO != jnat._SO and tsink._SO != jsink._SO


@pytest.mark.parametrize("relax", [False, True])
def test_solve_qp_2d_batch_bit_equal(rng, relax):
    n, m = 300, 10
    A = rng.normal(0, 1.0, (n, m, 2))
    b = rng.normal(0.5, 1.0, (n, m))
    pad = rng.uniform(size=(n, m)) < 0.2
    A[pad] = 0.0
    b[pad] = 0.0
    mask = (rng.uniform(size=(n, m)) < 0.7).astype(float) if relax else None
    got = tnat.solve_qp_2d_batch(A, b, mask)
    want = jnat.solve_qp_2d_batch(A, b, mask)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].any() and (not relax or got[2].max() > 0)
    assert tnat.qp_backend(A[0], b[0])[1] == jnat.qp_backend(A[0], b[0])[1]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_trajectory_files_cross_read(tmp_path, writer):
    rng = np.random.default_rng(1)
    chunks = [rng.normal(0, 1, (t, 6, 2)).astype(np.float32)
              for t in (5, 1, 17)]
    path = str(tmp_path / "run.cbt")
    write, read = ((tsink, jsink) if writer == "port" else (jsink, tsink))
    with write.TrajectorySink(path, n_agents=6, dims=2) as sink:
        for c in chunks:
            sink.append(c)
        sink.append(chunks[0][0])            # single-frame (N, D) form
    expect = np.concatenate(chunks + [chunks[0][:1]], axis=0)
    np.testing.assert_array_equal(read.read_trajectory(path), expect)
    np.testing.assert_array_equal(write.read_trajectory(path), expect)


def test_sink_rejects_bad_shapes_and_closed(tmp_path):
    sink = tsink.TrajectorySink(str(tmp_path / "bad.cbt"), n_agents=4,
                                dims=2)
    with pytest.raises(ValueError):
        sink.append(np.zeros((3, 5, 2), np.float32))     # wrong N
    assert sink.close() == 0
    with pytest.raises(ValueError):
        sink.append(np.zeros((1, 4, 2), np.float32))     # after close
    with pytest.raises(ValueError):
        tnat.solve_qp_2d_batch(np.zeros((2, 3, 2)), np.zeros((2, 4)))


@pytest.mark.parametrize("content", [b"NOPE" + b"\0" * 32, b"CBT1\x04",
                                     "truncated"])
def test_read_rejects_garbage(tmp_path, content):
    p = tmp_path / "junk.cbt"
    if content == "truncated":
        with tsink.TrajectorySink(str(p), n_agents=3, dims=2) as sink:
            sink.append(np.ones((4, 3, 2), np.float32))
        content = p.read_bytes()[:-8]
    p.write_bytes(content)
    with pytest.raises(ValueError):
        tsink.read_trajectory(str(p))
