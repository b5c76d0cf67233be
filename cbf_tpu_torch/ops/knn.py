"""k-NN danger gating: the hand-written Hopper kernels and their plain
versions (counterpart: cbf_tpu/ops/pallas_knn.py).

Kernels (CUDA C++ in ``cbf_tpu_torch/csrc/knn.cu``, built at first use by
``nvcc`` for ``sm_90a`` into a directory keyed by the source hash and
loaded through ctypes):

- ``knn_fused`` replaces ``_knn_kernel`` (N <= MAX_N_FUSED);
- ``knn_stream`` replaces ``_knn_kernel_blocked``/``_stream_step``
  (N <= MAX_N_BLOCKED, or forced by ``kernel="streaming"``): the columns
  split into ranges (:func:`stream_plan`), each range scanned into a
  per-row partial, the partials folded by a merge launch — or, with one
  range, the outputs written by the scan itself. Plain models of the two
  steps: :func:`stream_partials_plain` (with :func:`_warp_lists_model`,
  the range's lists as the kernel's warps form them) and
  :func:`stream_merge_plain`;
- ``knn_banded`` replaces ``_knn_kernel_banded`` (``gating="banded"``):
  the same contract over y-sorted rows, each 256-row block scanning only
  its window of sorted columns (:func:`knn_neighbors_banded`). After the
  y-sort (``torch.argsort``) the call is three launches: a prologue
  (gather, cast, window search), the window partials, and a merge that
  writes each sorted row to its agent.

All three compute the contract of :func:`knn_neighbors` (the banded one
within its windows); the source notes say how. Each also takes a member
axis, (B, N, 2): one launch (the banded form: one launch set) scans each
member's rows against that member's columns only — what ``jax.vmap``
makes of one ``pallas_call``. The falsifier's batches, the ensembles and
``torch.func.vmap`` reach it through :func:`knn_select` and
:func:`knn_neighbors_banded`, whose vmap rules fold the mapped axis into
that member axis.

Differentiation: :func:`knn_select` is an ``autograd.Function`` whose
backward is a zero gradient for x — the selection is piecewise constant
in the positions (``pallas_knn.knn_select``'s ``custom_vjp``), so a caller
on a gradient path recomputes every value it differentiates from the
positions through ``idx`` (:func:`knn_gating_pallas_diff`). The raw
gating entries raise under autograd instead of returning silent
constants.

A wrapper given a CUDA tensor launches its kernel or raises (also when
the build fails); only a tensor on the CPU goes to the plain version. ``LAUNCHES[name]`` counts kernel launches, so a run can show it
went through the kernels: a wrapper adds one where it launches; under CUDA
graph capture, where nothing launches, the compiled rollout takes back
what the wrappers added and adds it again at every replay
(:mod:`cbf_tpu_torch.rollout.engine`).

Radius: ``knn_fused`` and ``knn_stream`` take a float, or a float tensor
on the positions' device — 0-dim, or one radius per member (B,), which
the kernels read from a device array, member by member, so
``torch.func.vmap`` of a step whose radius is per member (the serving
layer's traced configs, :func:`cbf_tpu_torch.scenarios.swarm.
make_step_traced`) still makes one launch; the plain versions take the
same. ``knn_banded`` keeps one host float: its window rule is host math
over the radius, and a per-member radius raises, as the JAX package
refuses banded traced configs.

Two contracts coexist and both are kept: the kernels compare
``d^2 < r^2`` in float32 with r^2 formed from float32(radius) (the TPU
kernels' ``_pad_coords``), while :func:`cbf_tpu_torch.rollout.gating.
knn_gating` compares ``sqrt(d^2) < radius`` in the config dtype.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess

import numpy as np
import torch

from cbf_tpu_torch.utils.math import safe_norm

# The reference's bounds and tiles, same values. MAX_N_FUSED (the TPU's
# VMEM bound) still picks fused vs streaming, so both packages route alike;
# TILE/RTILE are the TPU kernels' row tiles and size nothing here; CTILE,
# the TPU's column block, tiles the streaming plain version. The CUDA
# kernels' own tiles and column split live in csrc/knn.cu alone. The banded
# form's windows are defined per RTILE block of the sorted order and in
# CTILE units, whatever tiles the kernel uses.
TILE = 128
MAX_N_FUSED = 8192
RTILE = 256
CTILE = 512
MAX_N_BLOCKED = 262144
KNN_MAX_K = 16       # csrc/knn.cu kMaxK: k is a template parameter there
_FAR = 1.0e6         # padding coordinate (pallas_knn._pad_coords)

# Launches per kernel; "<kernel>_members" counts the launches of it that
# took a member axis ((B, N, 2) input), which count under the kernel too,
# "<kernel>_radii" those that took a per-member radius array.
LAUNCHES = {"knn_fused": 0, "knn_stream": 0, "knn_banded": 0,
            "knn_fused_members": 0, "knn_stream_members": 0,
            "knn_banded_members": 0, "knn_fused_radii": 0,
            "knn_stream_radii": 0}
MAX_MEMBERS = 65535  # csrc/knn.cu: the member axis is a grid dimension

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "knn.cu")
BUILD_DIR = os.path.join(os.path.dirname(_SRC), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lib = None


def _find_nvcc() -> str | None:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    return None


def build_library() -> str:
    """Compile ``csrc/knn.cu`` (once per source hash) and return the path
    of the shared library. nvcc's output, including ``-Xptxas -v``'s
    register and shared-memory report, is kept beside it as ``.log``."""
    with open(_SRC, "rb") as fh:
        src = fh.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so_path = os.path.join(BUILD_DIR, f"knn-{key[:16]}.so")
    if os.path.exists(so_path):
        return so_path
    nvcc = _find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the k-NN kernels are "
            "built from cbf_tpu_torch/csrc/knn.cu with the CUDA toolkit; "
            "run on the CPU with device='cpu' instead")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.tmp{os.getpid()}"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, _SRC],
                          capture_output=True, text=True, check=False)
    with open(so_path[:-3] + ".log", "w", encoding="utf-8") as fh:
        fh.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {_SRC}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, so_path)    # atomic: no reader sees a partial file
    return so_path


def build_log() -> str:
    """nvcc's report for the current source (builds first if needed)."""
    with open(build_library()[:-3] + ".log", encoding="utf-8") as fh:
        return fh.read()


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.knn_fused_launch.argtypes = [p, i, i, f, p, i, p, p, p, p, p]
        lib.knn_fused_launch.restype = i
        lib.knn_stream_plan.argtypes = [i, p, p]
        lib.knn_stream_plan.restype = i
        lib.knn_stream_launch.argtypes = [p, i, i, f, p, i, i, p, p, p,
                                          p, p, p, p, p, p]
        lib.knn_stream_launch.restype = i
        lib.knn_banded_plan.argtypes = [i, i, i, p, p]
        lib.knn_banded_plan.restype = i
        lib.knn_banded_launch.argtypes = [p, i, i, f, i, p, i, i, p, p, p,
                                          p, p, p, p, p, p]
        lib.knn_banded_launch.restype = i
        lib.knn_band_prologue_launch.argtypes = [p, i, p, i, i, i, f, p, p,
                                                 p, p]
        lib.knn_band_prologue_launch.restype = i
        lib.knn_banded_agents_launch.argtypes = [p, i, p, i, i, f, f, i, i,
                                                 i, p, p, p, p, p, p, p,
                                                 p, p, p, p, p, p]
        lib.knn_banded_agents_launch.restype = i
        lib.knn_max_k.restype = i
        if lib.knn_max_k() != KNN_MAX_K:
            raise RuntimeError(f"knn.cu kMaxK={lib.knn_max_k()} disagrees "
                               f"with KNN_MAX_K={KNN_MAX_K}")
        _lib = lib
    return _lib


def _radius_sq(radius) -> float:
    """r^2 formed in float32 from float32(radius), as the TPU kernels'
    ``_pad_coords`` does (pallas_knn.py:90)."""
    r = np.float32(float(radius))
    return float(r * r)


def _radius_f32(radius) -> float:
    """float32(radius), as JAX's weak-typed scalar meets float32 ys."""
    return float(np.float32(radius))


# JAX's words for a per-member radius on the banded path
# (swarm.split_static_traced).
BANDED_TRACED_RADIUS = (
    'gating="banded" cannot ride the traced-config path: its window sizing '
    "is host-side float math over safety_distance (a traced scalar here) "
    "— use auto/pallas/jnp/streaming")


def _radius_array(radius, x):
    """A tensor radius as the kernels' per-member radius array: float32,
    one value per member of ``x`` ((N, 2): one member; (B, N, 2): B), on
    x's device — a 0-dim radius serves every member. Never read on the
    host."""
    members = x.shape[0] if x.dim() == 3 else 1
    if radius.device != x.device:
        raise ValueError(f"the radius tensor lies on {radius.device}, the "
                         f"positions on {x.device}")
    if radius.dim() == 0:
        radius = radius.expand(members)
    if tuple(radius.shape) != (members,):
        raise ValueError(f"a radius tensor is 0-dim or one value per "
                         f"member ({members},), got {tuple(radius.shape)}")
    return radius.to(torch.float32).contiguous()


def _radius_sq_t(radius, x):
    """The plain versions' r^2 for (..., N, 2) positions ``x``: a 0-dim
    float32 tensor from a float radius (:func:`_radius_sq`), or, from a
    tensor radius (0-dim, or (B,) for a (B, N, 2) ``x``), float32(r) *
    float32(r) per member, shaped to meet the (B, R, C) pair slab."""
    if not torch.is_tensor(radius):
        return torch.full((), _radius_sq(radius), dtype=torch.float32,
                          device=x.device)
    r = radius.to(device=x.device, dtype=torch.float32)
    lead = tuple(x.shape[:-2])
    if r.dim() and tuple(r.shape) != lead:
        raise ValueError(f"a radius tensor is 0-dim or one value per "
                         f"member {lead}, got {tuple(r.shape)}")
    return (r * r).reshape(lead + (1, 1)) if r.dim() else r * r


def _member_radius(radius, b: int):
    """Member ``b``'s radius of a float or a 0-dim / (B,) tensor."""
    if torch.is_tensor(radius) and radius.dim():
        return radius[b]
    return radius


def _check_launch(name: str, x, k: int | None, max_n: int,
                  dtypes=(torch.float32,), members: bool = False) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} launches on a CUDA tensor, got {x.device}")
    ranks = (2, 3) if members else (2,)
    if x.dtype not in dtypes or x.dim() not in ranks or x.shape[-1] != 2:
        kinds = "/".join(str(d).removeprefix("torch.") for d in dtypes)
        form = "(N, 2) or (B, N, 2)" if members else "(N, 2)"
        raise ValueError(f"{name} takes {form} {kinds} positions, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")
    if not 1 <= x.shape[-2] <= max_n:
        raise ValueError(f"{name} takes 1 <= N <= {max_n}, got "
                         f"{x.shape[-2]}")
    if x.dim() == 3 and not 1 <= x.shape[0] <= MAX_MEMBERS:
        raise ValueError(f"{name} takes 1 <= B <= {MAX_MEMBERS} members, "
                         f"got {x.shape[0]}")
    if k is not None and not 1 <= k <= KNN_MAX_K:
        raise ValueError(f"{name} takes 1 <= k <= {KNN_MAX_K}, got {k}")


def _outputs(n: int, k: int, device, lead=()):
    return (torch.empty(lead + (n, k), dtype=torch.int32, device=device),
            torch.empty(lead + (n, k), dtype=torch.float32, device=device),
            torch.empty(lead + (n,), dtype=torch.float32, device=device),
            torch.empty(lead + (n,), dtype=torch.int32, device=device))


def _partials(n: int, splits: int, k: int, device, lead=()):
    """(N, S, k) squared-distance and index partials plus (N, S) nearest
    and count partials of a split column scan (``lead``: a member axis)."""
    return (torch.empty(lead + (n, splits, k), dtype=torch.float32,
                        device=device),
            torch.empty(lead + (n, splits, k), dtype=torch.int32,
                        device=device),
            torch.empty(lead + (n, splits), dtype=torch.float32,
                        device=device),
            torch.empty(lead + (n, splits), dtype=torch.int32,
                        device=device))


def _stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``: every launch goes there."""
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {code}")


def _radius_args(radius, x):
    """(host r^2, radius array or None) for a launch: a float radius goes
    as the host r^2 (:func:`_radius_sq`), a tensor one as the per-member
    array (:func:`_radius_array`)."""
    if torch.is_tensor(radius):
        return 0.0, _radius_array(radius, x)
    return _radius_sq(radius), None


def _count(name: str, lead, radii) -> None:
    LAUNCHES[name] += 1
    if lead:
        LAUNCHES[f"{name}_members"] += 1
    if radii is not None:
        LAUNCHES[f"{name}_radii"] += 1


def knn_fused(x, radius, k: int):
    """Launch ``knn_fused`` on (N, 2) — or, one launch for B members,
    (B, N, 2) — float32 CUDA positions. ``radius``: a float, or a float
    tensor on x's device, 0-dim or one radius per member (B,), which the
    kernel reads per member (never the host). Returns (idx, dist,
    nearest, count) — see :func:`knn_neighbors` — with the same leading
    axes."""
    _check_launch("knn_fused", x, k, MAX_N_FUSED, members=True)
    lib = _library()
    lead, n = tuple(x.shape[:-2]), x.shape[-2]
    r2, radii = _radius_args(radius, x)
    idx, dist, nearest, count = _outputs(n, k, x.device, lead)
    with torch.cuda.device(x.device):
        code = lib.knn_fused_launch(
            x.data_ptr(), math.prod(lead), n, r2,
            None if radii is None else radii.data_ptr(), k,
            idx.data_ptr(),
            dist.data_ptr(), nearest.data_ptr(), count.data_ptr(),
            _stream_ptr(x.device))
    _raise_on("knn_fused", code)
    _count("knn_fused", lead, radii)
    return idx, dist, nearest, count


_plans: dict = {}


def _plan(name: str, device, *args) -> tuple[int, int]:
    """(cols_per_split, splits) from csrc/knn.cu's ``<name>_plan`` on
    ``device``, asked once per (name, device, args): the split depends on
    nothing else. The library is loaded (or its build raises) first."""
    lib = _library()
    key = (name, torch.device(device), args)
    if key not in _plans:
        cols, splits = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(device):
            _raise_on(f"{name} plan", getattr(lib, f"{name}_plan")(
                *args, ctypes.byref(cols), ctypes.byref(splits)))
        _plans[key] = (cols.value, splits.value)
    return _plans[key]


def stream_plan(n: int, device) -> tuple[int, int]:
    """(cols_per_split, splits): the column ranges ``knn_stream`` splits N
    columns into on ``device``, as csrc/knn.cu chooses them."""
    return _plan("knn_stream", device, n)


def knn_stream(x, radius, k: int):
    """Launch ``knn_stream`` (range partials + merge, or one range written
    straight to the outputs) on (N, 2) or (B, N, 2) float32 CUDA
    positions. Same contract as :func:`knn_fused`, the radius array
    included."""
    _check_launch("knn_stream", x, k, MAX_N_BLOCKED, members=True)
    lib = _library()
    lead, n = tuple(x.shape[:-2]), x.shape[-2]
    r2, radii = _radius_args(radius, x)
    _, splits = stream_plan(n, x.device)
    outs = _outputs(n, k, x.device, lead)
    parts = _partials(n, splits, k, x.device, lead) if splits > 1 else ()
    part_ptrs = [t.data_ptr() for t in parts] or [None] * 4
    with torch.cuda.device(x.device):
        code = lib.knn_stream_launch(
            x.data_ptr(), math.prod(lead), n, r2,
            None if radii is None else radii.data_ptr(), k, splits,
            *part_ptrs,
            *(t.data_ptr() for t in outs), _stream_ptr(x.device))
    _raise_on("knn_stream", code)
    _count("knn_stream", lead, radii)
    return outs


def _band_pad(n: int) -> int:
    """Rows padded to whole RTILE and CTILE blocks (``_pad_coords``)."""
    blk = max(RTILE, CTILE)
    return max(blk, -(-n // blk) * blk)


def _band_window(n: int, window_blocks: int) -> tuple[int, int]:
    """(n_pad, w): the padded rows and the window in CTILE blocks, clipped
    to the padded column count."""
    if window_blocks < 1:
        raise ValueError(f"window_blocks must be >= 1, got {window_blocks}")
    n_pad = _band_pad(n)
    return n_pad, int(min(window_blocks, n_pad // CTILE))


def band_setup(x, radius, window_blocks: int):
    """The banded form's prologue as PyTorch ops (pallas_knn.py:347-368),
    in the reference's order and dtypes: rows sorted by y in the input
    dtype (stable, as ``jnp.argsort``), cast to float32; per RTILE block of
    the sorted order the window start (left ``searchsorted`` of the block's
    first y minus the radius, clipped to ``[0, n_pad - w*CTILE]``, element
    units) and the overflow flag (the right ``searchsorted`` of its last y
    plus the radius lies past the window).

    Returns (order (N,) int64, xs (N, 2) float32 sorted, starts
    (n_pad // RTILE,) int32, block_overflow (n_pad // RTILE,) bool, w —
    window blocks, clipped to the padded column count). A (B, N, 2) input
    gives each member's, stacked."""
    if x.dim() == 3:
        per = [band_setup(m, radius, window_blocks) for m in x]
        return _stacked(p[:4] for p in per) + (per[0][4],)
    n = x.shape[0]
    n_pad, w = _band_window(n, window_blocks)
    wlen = w * CTILE
    order = torch.argsort(x[:, 1], stable=True)
    xs = x[order].to(torch.float32).contiguous()
    ys = torch.full((n_pad,), 2.0 * _FAR, dtype=torch.float32,
                    device=x.device)
    ys[:n] = xs[:, 1]
    r = _radius_f32(radius)
    row0 = torch.arange(0, n_pad, RTILE, device=x.device)
    lo = torch.searchsorted(ys[:n], ys[row0] - r)
    starts = torch.clamp(lo, 0, n_pad - wlen).to(torch.int32)
    row_end = torch.clamp(row0 + RTILE, max=n) - 1
    hi = torch.searchsorted(ys[:n], ys[row_end] + r, right=True)
    return order, xs, starts, hi > starts + wlen, w


def band_unsort(order, block_overflow, idx_s, dist_s, near_s, cnt_s):
    """Sorted-order results back to agent order (pallas_knn.py:403-409):
    rows through the inverse permutation, neighbour ids through the sort
    order — so an empty slot reports ``order[0]``. Returns (idx, dist,
    nearest, overflow, count)."""
    n = order.shape[0]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=order.device)
    idx = order[idx_s.to(torch.int64)][inv].to(torch.int32)
    overflow = torch.repeat_interleave(block_overflow, RTILE)[:n][inv]
    return idx, dist_s[inv], near_s[inv], overflow, cnt_s[inv]


def band_plan(n: int, w: int, device, members: int = 1) -> tuple[int, int]:
    """(cols_per_split, splits): the ranges ``knn_banded`` splits each
    ``w``-block window into on ``device`` for ``members`` swarms of N rows,
    as csrc/knn.cu chooses them."""
    return _plan("knn_banded", device, members, n, w)


def _band_buffers(x, n_pad: int):
    """The y-sort of each member's rows of ``x`` ((N, 2) or (B, N, 2);
    stable, in their dtype) and the buffers the prologue kernel fills:
    (order, xs, starts, block_overflow), with ``x``'s leading axes."""
    dev, lead = x.device, tuple(x.shape[:-2])
    return (torch.argsort(x[..., 1], dim=-1, stable=True),
            torch.empty(x.shape, dtype=torch.float32, device=dev),
            torch.empty(lead + (n_pad // RTILE,), dtype=torch.int32,
                        device=dev),
            torch.empty(lead + (n_pad // RTILE,), dtype=torch.bool,
                        device=dev))


def _count_banded(lead) -> None:
    LAUNCHES["knn_banded"] += 1
    if lead:
        LAUNCHES["knn_banded_members"] += 1


def band_prologue(x, radius, window_blocks: int):
    """Launch ``knn_banded``'s prologue kernel alone on (N, 2) — or, one
    launch for B members, (B, N, 2) — float32 or float64 CUDA positions:
    the y-sort, then one launch that gathers the sorted rows to float32
    and finds each RTILE block's window start and overflow flag. Returns
    :func:`band_setup`'s 5-tuple (with the leading axes), bit for bit (its
    plain model in the kernel's form: :func:`band_prologue_plain`)."""
    _check_launch("band_prologue", x, None, MAX_N_BLOCKED,
                  dtypes=(torch.float32, torch.float64), members=True)
    lib = _library()
    lead, n = tuple(x.shape[:-2]), x.shape[-2]
    n_pad, w = _band_window(n, window_blocks)
    dev = x.device
    order, xs, starts, block_overflow = _band_buffers(x, n_pad)
    with torch.cuda.device(dev):
        code = lib.knn_band_prologue_launch(
            x.data_ptr(), int(x.dtype == torch.float64), order.data_ptr(),
            math.prod(lead), n, w, _radius_f32(radius), xs.data_ptr(),
            starts.data_ptr(), block_overflow.data_ptr(), _stream_ptr(dev))
    _raise_on("band_prologue", code)
    _count_banded(lead)
    return order, xs, starts, block_overflow, w


def knn_banded_sorted(xs, starts, radius, k: int, w: int):
    """Launch ``knn_banded``'s window partials and the sorted-order merge
    on y-sorted float32 CUDA positions ((N, 2), or (B, N, 2) for B
    members in one launch each) and their window starts
    (:func:`band_setup`). Returns (idx, dist, nearest, count) in sorted
    order, ids sorted indices (plain: :func:`knn_banded_sorted_plain`)."""
    _check_launch("knn_banded", xs, k, MAX_N_BLOCKED, members=True)
    lib = _library()
    lead, n = tuple(xs.shape[:-2]), xs.shape[-2]
    if (starts.dtype != torch.int32 or starts.device != xs.device
            or tuple(starts.shape) != lead + (_band_pad(n) // RTILE,)
            or not starts.is_contiguous()):
        raise ValueError("knn_banded takes contiguous int32 window starts, "
                         "one per RTILE block of the padded rows of each "
                         "member, on xs's device")
    members = math.prod(lead)
    _, splits = band_plan(n, w, xs.device, members)
    outs = _outputs(n, k, xs.device, lead)
    parts = _partials(n, splits, k, xs.device, lead)
    with torch.cuda.device(xs.device):
        code = lib.knn_banded_launch(
            xs.data_ptr(), members, n, _radius_sq(radius), k,
            starts.data_ptr(), w, splits,
            *(t.data_ptr() for t in parts + outs), _stream_ptr(xs.device))
    _raise_on("knn_banded", code)
    _count_banded(lead)
    return outs


def knn_banded(x, radius, k: int, *, window_blocks: int):
    """:func:`knn_neighbors_banded` through the ``knn_banded`` kernels on
    (N, 2) — or, for B members at once, (B, N, 2) — float32 or float64
    CUDA positions: the y-sort (one batched ``torch.argsort``), then one
    call into csrc/knn.cu that launches the prologue, the window partials
    and the merge into agent order, each over every member — no PyTorch
    op after the sort. Outputs carry ``x``'s leading axes. The radius is
    a host float: a tensor radius raises (no per-member radius here)."""
    if torch.is_tensor(radius):
        raise ValueError("knn_banded takes its radius as a host float; "
                         + BANDED_TRACED_RADIUS)
    _check_launch("knn_banded", x, k, MAX_N_BLOCKED,
                  dtypes=(torch.float32, torch.float64), members=True)
    lib = _library()
    lead, n = tuple(x.shape[:-2]), x.shape[-2]
    members = math.prod(lead)
    n_pad, w = _band_window(n, window_blocks)
    dev = x.device
    _, splits = band_plan(n, w, dev, members)
    order, xs, starts, block_overflow = _band_buffers(x, n_pad)
    parts = _partials(n, splits, k, dev, lead)
    idx, dist, nearest, count = _outputs(n, k, dev, lead)
    overflow = torch.empty(lead + (n,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        code = lib.knn_banded_agents_launch(
            x.data_ptr(), int(x.dtype == torch.float64), order.data_ptr(),
            members, n, _radius_f32(radius), _radius_sq(radius), k, w,
            splits, xs.data_ptr(), starts.data_ptr(),
            block_overflow.data_ptr(), *(t.data_ptr() for t in parts),
            idx.data_ptr(), dist.data_ptr(), nearest.data_ptr(),
            overflow.data_ptr(), count.data_ptr(), _stream_ptr(dev))
    _raise_on("knn_banded", code)
    _count_banded(lead)
    return idx, dist, nearest, overflow, count


# -- plain versions ---------------------------------------------------------

def _pair_d2(xr, xc):
    """(..., R, C) float32 squared distances of (..., R, 2) rows and
    (..., C, 2) columns, difference form, each operation rounded on its
    own (no FMA) — bit-equal to the kernels' pair_d2."""
    dx = xr[..., :, None, 0] - xc[..., None, :, 0]
    dy = xr[..., :, None, 1] - xc[..., None, :, 1]
    return dx * dx + dy * dy


def _sqrt_rn(d2):
    """Correctly rounded float32 sqrt (the kernels' __fsqrt_rn): taken in
    float64 and rounded once to float32, which is exact rounding for
    sqrt (53 >= 2*24 + 2 bits). PyTorch's vectorized CPU sqrt can be an
    ulp off."""
    return torch.sqrt(d2.to(torch.float64)).to(torch.float32)


def _select_k(key, k: int, ids=None):
    """k first-minimizer passes over ``key`` (..., R, C): (ids (..., R, k)
    int32, keys (..., R, k)); ``ids`` maps columns to reported ids (default
    the column itself). Empty slots (key +inf) report id 0 — the TPU
    kernels' convention."""
    key = key.clone()
    out_i, out_d = [], []
    for _ in range(k):
        m, j = torch.min(key, dim=-1)      # first minimizer on ties
        sel = (j if ids is None
               else torch.gather(ids, -1, j[..., None])[..., 0])
        out_i.append(torch.where(torch.isfinite(m), sel.to(torch.int32), 0))
        out_d.append(m)
        key.scatter_(-1, j[..., None], torch.inf)
    return torch.stack(out_i, dim=-1), torch.stack(out_d, dim=-1)


def knn_neighbors_plain(x, radius, k: int):
    """Plain PyTorch version of ``knn_fused``: the (N, N) slab and k
    first-minimizer passes, as ``_knn_kernel`` does per tile. ``x`` is
    (N, 2) or, with the kernel's member axis, (B, N, 2)."""
    x = x.to(torch.float32)
    n = x.shape[-2]
    r2 = _radius_sq_t(radius, x)
    d2 = _pair_d2(x, x)
    is_self = torch.eye(n, dtype=torch.bool, device=x.device)
    nearest = _sqrt_rn(torch.amin(torch.where(is_self, torch.inf, d2),
                                  dim=-1))
    eligible = (d2 < r2) & (d2 > 0.0)
    count = torch.sum(eligible, dim=-1, dtype=torch.int32)
    idx, key = _select_k(torch.where(eligible, d2, torch.inf), k)
    return idx, _sqrt_rn(key), nearest, count


def knn_neighbors_blocked_plain(x, radius, k: int):
    """Plain PyTorch version of ``knn_stream``, in the streaming kernel's
    shape: CTILE column blocks pass by, each folds nearest and count, and
    its block-local top-k merges with the running squared top-k by an
    exact 2k-wide merge whose ties go to the first (running) slot. ``x``
    is (N, 2) or (B, N, 2), as for :func:`knn_neighbors_plain`."""
    x = x.to(torch.float32)
    lead, n = tuple(x.shape[:-2]), x.shape[-2]
    dev = x.device
    r2 = _radius_sq_t(radius, x)
    rows = torch.arange(n, device=dev)
    run_i = torch.zeros(lead + (n, k), dtype=torch.int32, device=dev)
    run_d2 = torch.full(lead + (n, k), torch.inf, dtype=torch.float32,
                        device=dev)
    near = torch.full(lead + (n,), torch.inf, dtype=torch.float32,
                      device=dev)
    count = torch.zeros(lead + (n,), dtype=torch.int32, device=dev)
    for c0 in range(0, n, CTILE):
        cols = torch.arange(c0, min(n, c0 + CTILE), device=dev)
        d2 = _pair_d2(x, x[..., c0:c0 + CTILE, :])
        is_self = cols[None, :] == rows[:, None]
        near = torch.minimum(near, torch.amin(
            torch.where(is_self, torch.inf, d2), dim=-1))
        eligible = (d2 < r2) & (d2 > 0.0)
        count = count + torch.sum(eligible, dim=-1, dtype=torch.int32)
        col_ids = cols.to(torch.int32).expand(lead + (n, cols.shape[0]))
        bk_i, bk_d2 = _select_k(torch.where(eligible, d2, torch.inf), k,
                                ids=col_ids)
        run_i, run_d2 = _select_k(torch.cat([run_d2, bk_d2], dim=-1), k,
                                  ids=torch.cat([run_i, bk_i], dim=-1))
    return run_i, _sqrt_rn(run_d2), _sqrt_rn(near), count


def _ranges(n: int, cols_per_split: int, splits: int):
    """The column ranges [c0, c1) of a split: S contiguous ranges of
    ``cols_per_split`` columns, the last cut at N."""
    if cols_per_split < 1 or splits != -(-n // cols_per_split):
        raise ValueError(f"{splits} ranges of {cols_per_split} columns do "
                         f"not split {n} columns")
    return [(c0, min(n, c0 + cols_per_split))
            for c0 in range(0, n, cols_per_split)]


def stream_partials_plain(x, radius, k: int, cols_per_split: int,
                          splits: int):
    """Plain model of ``knn_stream``'s range partials: per row and column
    range, the k lexicographically smallest (d^2, column) in-radius keys
    (+inf / 0 on empty slots), the nearest d^2 with self excluded and the
    in-radius count. Returns (d2 (N, S, k) float32, idx (N, S, k) int32,
    near (N, S) float32, count (N, S) int32); (B, N, 2) positions, with a
    float or a (B,) radius, give each member's, stacked."""
    if x.dim() == 3:
        return _stacked(stream_partials_plain(
            m, _member_radius(radius, b), k, cols_per_split, splits)
            for b, m in enumerate(x))
    x = x.to(torch.float32)
    n = x.shape[0]
    r2 = _radius_sq_t(radius, x)
    rows = torch.arange(n, device=x.device)
    parts = ([], [], [], [])
    for c0, c1 in _ranges(n, cols_per_split, splits):
        cols = torch.arange(c0, c1, device=x.device)
        d2 = _pair_d2(x, x[c0:c1])
        near = torch.amin(torch.where(cols[None, :] == rows[:, None],
                                      torch.inf, d2), dim=1)
        eligible = (d2 < r2) & (d2 > 0.0)
        ids, keys = _select_k(torch.where(eligible, d2, torch.inf), k,
                              ids=cols.to(torch.int32)[None, :].expand(n, -1))
        for out, part in zip(parts, (keys, ids, near, torch.sum(
                eligible, dim=1, dtype=torch.int32))):
            out.append(part)
    return tuple(torch.stack(p, dim=1) for p in parts)


def _insert_sorted(bd, bi, d, j):
    """``topk_insert`` over a batch of sorted lists (..., k): d goes in
    front of the first strictly larger key (after every equal one), the
    tail shifts down and the last entry drops; no change where no key is
    larger."""
    k = bd.shape[-1]
    pos = torch.sum(bd <= d[..., None], dim=-1, keepdim=True)
    slots = torch.arange(k, device=bd.device)
    prev_d = torch.cat([bd[..., :1], bd[..., :-1]], dim=-1)
    prev_i = torch.cat([bi[..., :1], bi[..., :-1]], dim=-1)
    bd = torch.where(slots < pos, bd, torch.where(slots == pos, d[..., None],
                                                  prev_d))
    bi = torch.where(slots < pos, bi, torch.where(slots == pos, j[..., None],
                                                  prev_i))
    return bd, bi


def _lex_minima(ld, li, k: int):
    """``warp_topk`` over a batch: lists (..., L, m), each sorted, meet by k
    rounds of the lexicographic (d^2, column) minimum of their heads, the
    winner popping its head. Returns (..., k) keys and ids, (+inf, 0) once
    every list is empty."""
    pad = torch.full(ld.shape[:-1] + (1,), torch.inf, dtype=ld.dtype,
                     device=ld.device)
    ld = torch.cat([ld, pad], dim=-1)
    li = torch.cat([li, torch.zeros_like(pad, dtype=li.dtype)], dim=-1)
    head = torch.zeros(ld.shape[:-1] + (1,), dtype=torch.int64,
                       device=ld.device)
    big = torch.iinfo(li.dtype).max
    out_d, out_i = [], []
    for _ in range(k):
        hd = torch.gather(ld, -1, head)[..., 0]
        hi = torch.gather(li, -1, head)[..., 0]
        m = torch.amin(hd, dim=-1)
        c = torch.amin(torch.where(hd == m[..., None], hi, big), dim=-1)
        live = torch.isfinite(m)
        out_d.append(m)
        out_i.append(torch.where(live, c, 0))
        won = (hd == m[..., None]) & (hi == c[..., None]) & live[..., None]
        head = head + won[..., None].to(torch.int64)
    return torch.stack(out_d, dim=-1), torch.stack(out_i, dim=-1)


def _warp_lists_model(x, radius, k: int, c0: int, c1: int):
    """One range's partial as ``knn_stream``'s warps form it, for every
    row: the range's 32-column steps split into two halves (the first
    ceil(steps / 2) steps, then the rest); lane l of a half takes the
    columns c0 + 32 t + l of its steps in increasing order (columns at or
    past c1 read +inf coordinates) into a sorted k-list by insertion; each
    half's 32 lane lists meet by k lexicographic minima, then the two
    halves' k-lists by k more. Returns (d2 (N, k), idx (N, k) int32,
    near (N,), count (N,) int32), equal to :func:`stream_partials_plain`'s
    slice for the range; (B, N, 2) positions, with a float or a (B,)
    radius, give each member's, stacked."""
    if x.dim() == 3:
        return _stacked(_warp_lists_model(m, _member_radius(radius, b), k,
                                          c0, c1)
                        for b, m in enumerate(x))
    x = x.to(torch.float32)
    n, dev = x.shape[0], x.device
    r2 = _radius_sq_t(radius, x)
    rows = torch.arange(n, device=dev)
    lanes = torch.arange(32, device=dev)
    steps = -(-(c1 - c0) // 32)
    half_steps = -(-steps // 2)
    near = torch.full((n,), torch.inf, dtype=torch.float32, device=dev)
    count = torch.zeros((n,), dtype=torch.int32, device=dev)
    halves = []
    for t0, t1 in ((0, half_steps), (half_steps, steps)):
        bd = torch.full((n, 32, k), torch.inf, dtype=torch.float32,
                        device=dev)
        bi = torch.zeros((n, 32, k), dtype=torch.int32, device=dev)
        for t in range(t0, t1):
            cols = c0 + 32 * t + lanes
            live = cols < c1
            xc = torch.where(live[:, None], x[torch.clamp(cols, max=n - 1)],
                             torch.inf)
            d2 = _pair_d2(x, xc)                                  # (N, 32)
            near = torch.minimum(near, torch.amin(torch.where(
                cols[None, :] == rows[:, None], torch.inf, d2), dim=1))
            eligible = (d2 < r2) & (d2 > 0.0)
            count = count + torch.sum(eligible, dim=1, dtype=torch.int32)
            bd, bi = _insert_sorted(
                bd, bi, torch.where(eligible, d2, torch.inf),
                cols.to(torch.int32)[None, :].expand(n, -1))
        halves.append(_lex_minima(bd, bi, k))
    od, oi = _lex_minima(torch.cat([h[0] for h in halves], 1)[..., None],
                         torch.cat([h[1] for h in halves], 1)[..., None], k)
    return od, oi, near, count


def stream_merge_plain(part_d2, part_idx, part_near, part_cnt):
    """Plain model of ``knn_stream``'s merge (``fold_partials``): per row,
    the ranges' sorted partials folded in range order into a running
    k-list by insertion after equal keys (ties keep the lower column), the
    nearest d^2 by min and the counts by sum. Returns (idx, dist, nearest,
    count) as :func:`knn_neighbors_blocked_plain` does."""
    n, splits, k = part_d2.shape
    bd = torch.full((n, k), torch.inf, dtype=torch.float32,
                    device=part_d2.device)
    bi = torch.zeros((n, k), dtype=torch.int32, device=part_d2.device)
    for s in range(splits):
        for t in range(k):
            bd, bi = _insert_sorted(bd, bi, part_d2[:, s, t],
                                    part_idx[:, s, t])
    return (bi, _sqrt_rn(bd), _sqrt_rn(torch.amin(part_near, dim=1)),
            torch.sum(part_cnt, dim=1, dtype=torch.int32))


def _stacked(per) -> tuple:
    """Per-member output tuples stacked along a new leading member axis."""
    return tuple(torch.stack(parts) for parts in zip(*per))


def knn_banded_sorted_plain(xs, starts, radius, k: int, w: int):
    """Plain PyTorch version of :func:`knn_banded_sorted`, in the
    streaming kernel's shape: per sorted row, its block's W CTILE column
    blocks pass by in order, each folding nearest and count, its
    block-local top-k merged with the running one by the exact 2k merge
    (ties to the running slot). Returns (idx, dist, nearest, count) in
    sorted order, ids sorted indices; (B, N, 2) positions with (B, ...)
    starts give each member's, stacked."""
    if xs.dim() == 3:
        return _stacked(knn_banded_sorted_plain(m, s, radius, k, w)
                        for m, s in zip(xs, starts))
    n = xs.shape[0]
    dev = xs.device
    n_pad = starts.shape[0] * RTILE
    xp = torch.empty((n_pad, 2), dtype=torch.float32, device=dev)
    xp[:, 0], xp[:, 1] = _FAR, 2.0 * _FAR
    xp[:n] = xs
    r2 = torch.full((), _radius_sq(radius), dtype=torch.float32, device=dev)
    rows = torch.arange(n, device=dev)
    row_start = starts.to(torch.int64)[rows // RTILE]
    lanes = torch.arange(CTILE, device=dev)
    run_i = torch.zeros((n, k), dtype=torch.int32, device=dev)
    run_d2 = torch.full((n, k), torch.inf, dtype=torch.float32, device=dev)
    near = torch.full((n,), torch.inf, dtype=torch.float32, device=dev)
    count = torch.zeros((n,), dtype=torch.int32, device=dev)
    for j in range(w):
        cols = row_start[:, None] + j * CTILE + lanes[None, :]   # (N, CTILE)
        xc = xp[cols]
        dx = xs[:, None, 0] - xc[..., 0]
        dy = xs[:, None, 1] - xc[..., 1]
        d2 = dx * dx + dy * dy
        in_range = cols < n
        near = torch.minimum(near, torch.amin(
            torch.where((cols == rows[:, None]) | ~in_range, torch.inf, d2),
            dim=1))
        eligible = (d2 < r2) & (d2 > 0.0) & in_range
        count = count + torch.sum(eligible, dim=1, dtype=torch.int32)
        bk_i, bk_d2 = _select_k(torch.where(eligible, d2, torch.inf), k,
                                ids=cols.to(torch.int32))
        run_i, run_d2 = _select_k(torch.cat([run_d2, bk_d2], dim=1), k,
                                  ids=torch.cat([run_i, bk_i], dim=1))
    return run_i, _sqrt_rn(run_d2), _sqrt_rn(near), count


def knn_neighbors_banded_plain(x, radius, k: int, *, window_blocks: int):
    """Plain PyTorch version of ``knn_banded``: the sort and windows of
    :func:`band_setup`, the window scan of :func:`knn_banded_sorted_plain`,
    and the mapping back of :func:`band_unsort`. A (B, N, 2) input runs
    each member alone and stacks the results — B single calls, bit for
    bit."""
    if x.dim() == 3:
        return _stacked(knn_neighbors_banded_plain(
            m, radius, k, window_blocks=window_blocks) for m in x)
    order, xs, starts, block_overflow, w = band_setup(x, radius,
                                                      window_blocks)
    return band_unsort(order, block_overflow,
                       *knn_banded_sorted_plain(xs, starts, radius, k, w))


def _warp_search_model(y_at, n: int, v, right: bool):
    """The prologue kernel's ``warp_search`` for a batch of blocks: per
    query v, the count of the sorted float32 ys[0, n) below v (at or below
    with ``right``) — ``torch.searchsorted``'s answer — found by rounds of
    32 evenly spaced probes, of which those that hold form a prefix.
    ``y_at(rows)`` reads ys through the sort order, as the kernel does."""
    lo = torch.zeros(v.shape, dtype=torch.int64, device=v.device)
    hi = torch.full(v.shape, n, dtype=torch.int64, device=v.device)
    lanes = torch.arange(32, device=v.device)
    while bool((hi > lo).any()):
        live = hi > lo
        stride = (hi - lo + 31) // 32
        p = lo[:, None] + lanes[None, :] * stride[:, None]
        probe = p < hi[:, None]
        y = y_at(torch.where(probe, p, 0))
        below = probe & ((y <= v[:, None]) if right else (y < v[:, None]))
        t = below.sum(dim=1)
        done = live & (t == 0)
        step = live & (t > 0)
        hi = torch.where(done, lo,
                         torch.where(step, torch.minimum(hi, lo + t * stride),
                                     hi))
        lo = torch.where(step, lo + (t - 1) * stride + 1, lo)
    return lo


def band_prologue_plain(x, radius, window_blocks: int):
    """Plain model of the prologue kernel (:func:`band_prologue`), in its
    form: the stable y-sort; the sorted rows gathered and cast; per RTILE
    block, the y of its first and last row read through the sort order
    (2e6 for padding rows), each moved by the float32 radius in one
    rounding, and :func:`_warp_search_model` for the window start (clamped)
    and the overflow flag. No padded ys array is formed. Returns
    :func:`band_setup`'s 5-tuple, which it equals bit for bit."""
    n = x.shape[0]
    n_pad, w = _band_window(n, window_blocks)
    wlen = w * CTILE
    dev = x.device
    order = torch.argsort(x[:, 1], stable=True)
    xs = x[order].to(torch.float32)

    def y_at(rows):
        return x[order[rows], 1].to(torch.float32)

    r = _radius_f32(radius)
    row0 = torch.arange(0, n_pad, RTILE, device=dev)
    y0 = torch.where(row0 < n, y_at(torch.clamp(row0, max=n - 1)),
                     torch.tensor(2.0 * _FAR, dtype=torch.float32,
                                  device=dev))
    row_end = torch.clamp(row0 + RTILE, max=n) - 1
    lo = _warp_search_model(y_at, n, y0 - r, right=False)
    hi = _warp_search_model(y_at, n, y_at(row_end) + r, right=True)
    starts = torch.clamp(lo, 0, n_pad - wlen).to(torch.int32)
    return order, xs, starts, hi > starts.to(torch.int64) + wlen, w


def band_scatter_plain(order, block_overflow, idx_s, dist_s, near_s, cnt_s):
    """Plain model of ``knn_banded``'s merge epilogue, in its form: sorted
    row i written straight to agent ``order[i]``, its ids mapped through
    ``order`` (an empty slot's 0 becomes ``order[0]``), the overflow flag
    of its RTILE block beside them. Equals :func:`band_unsort` bit for
    bit. Returns (idx, dist, nearest, overflow, count)."""
    n = order.shape[0]

    def put(src):
        out = torch.empty_like(src)
        out[order] = src
        return out

    rows = torch.arange(n, device=order.device)
    return (put(order[idx_s.to(torch.int64)].to(torch.int32)), put(dist_s),
            put(near_s), put(block_overflow[rows // RTILE]), put(cnt_s))


# -- entries ----------------------------------------------------------------

def knn_neighbors(x, radius, k: int):
    """Fused k-NN danger gating over (N, 2) positions (cast to float32).

    Returns (idx (N, k) int32 — 0 on empty slots, dist (N, k) float32 —
    +inf on empty slots, nearest (N,) float32 — nearest-any distance,
    count (N,) int32 — in-radius candidates including any beyond k).
    A CUDA tensor launches ``knn_fused``; a CPU tensor runs the plain
    version."""
    x = x.to(torch.float32).contiguous()
    if x.device.type == "cpu":
        return knn_neighbors_plain(x, radius, k)
    return knn_fused(x, radius, k)


def knn_neighbors_blocked(x, radius, k: int):
    """Streaming-kernel form of :func:`knn_neighbors`, same contract."""
    x = x.to(torch.float32).contiguous()
    if x.device.type == "cpu":
        return knn_neighbors_blocked_plain(x, radius, k)
    return knn_stream(x, radius, k)


def _banded_dispatch(x, radius, k: int, window_blocks: int):
    """The banded search on (N, 2) or (B, N, 2) positions: the kernels on
    a CUDA tensor, the plain version on a CPU one. The radius is one host
    float (its window rule is host math over it): a per-member radius
    raises, as the JAX package refuses banded traced configs."""
    if torch.is_tensor(radius) and radius.dim():
        raise ValueError(BANDED_TRACED_RADIUS)
    x = x.contiguous()
    if x.device.type == "cpu":
        return knn_neighbors_banded_plain(x, radius, k,
                                          window_blocks=window_blocks)
    return knn_banded(x, radius, k, window_blocks=window_blocks)


class _KnnBanded(torch.autograd.Function):
    """:func:`knn_neighbors_banded`'s Function: forward the dispatch, a
    vmap rule that runs the mapped axis as the kernels' member axis — one
    launch set for the whole batch — and no gradient: the JAX package's
    banded kernel has no AD rule, and its gradient engine forces
    ``gating="jnp"``, so a backward through it raises."""

    @staticmethod
    def forward(x, radius, k, window_blocks):
        return _banded_dispatch(x, radius, k, window_blocks)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[0], output[3], output[4])

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            "the banded k-NN search has no gradient (the JAX package's "
            "banded kernel has none, and its gradient engine forces "
            "gating='jnp'); differentiate through gating='jnp' or "
            "knn_gating_pallas_diff")

    @staticmethod
    def vmap(info, in_dims, x, radius, k, window_blocks):
        if in_dims[1] is not None:
            raise ValueError(BANDED_TRACED_RADIUS)
        if in_dims[0] is None:
            return _banded_dispatch(x, radius, k, window_blocks), (None,) * 5
        x = x.movedim(in_dims[0], 0)
        if x.dim() != 3:
            raise ValueError(f"knn_neighbors_banded maps over (N, 2) "
                             f"positions, got a batch of "
                             f"{tuple(x.shape[1:])}")
        # Through the Function again, so a backward still meets its rule.
        return _KnnBanded.apply(x, radius, k, window_blocks), (0,) * 5


def knn_neighbors_banded(x, radius, k: int, *, window_blocks: int):
    """O(N·W) y-sorted banded k-NN gating over (N, 2) positions (the
    sort runs in their dtype, the distances in float32).

    Returns (idx (N, k) int32 — ``order[0]`` on empty slots, dist (N, k),
    nearest (N,) — window-local, exact up to the radius, overflow (N,)
    bool — the row's block needed more than its window, count (N,) int32
    — in-radius candidates seen in the window). A CUDA tensor launches
    ``knn_banded``; a CPU tensor runs the plain version. A member axis —
    a (B, N, 2) input, or a tensor batched by ``torch.func.vmap`` — runs
    every member in one launch set, each member's rows against its own
    columns and windows, overflow flagged per member. No gradient: a
    backward through it raises."""
    return _KnnBanded.apply(x, radius, k, window_blocks)


def supported(n: int) -> bool:
    """Whether the kernel contract applies: N within the streaming
    kernel's bound. On the CPU the same contract runs as plain torch, so
    the device does not enter the decision (the JAX package's ``auto``
    takes its jnp path off-TPU instead)."""
    return n <= MAX_N_BLOCKED


def uses_fused(n: int, kernel: str = "auto") -> bool:
    """The fused-vs-streaming routing decision of :func:`_kernel_dispatch`."""
    if kernel not in ("auto", "streaming"):
        raise ValueError(f"kernel must be auto|streaming, got {kernel!r}")
    return n <= MAX_N_FUSED and kernel != "streaming"


def _kernel_dispatch(x, radius, k: int, kernel: str = "auto"):
    """Fused-vs-streaming dispatch — the one routing decision, for (N, 2)
    or member-batched (B, N, 2) positions. ``kernel="streaming"`` forces
    the streaming kernel below the fused bound."""
    fn = knn_neighbors if uses_fused(x.shape[-2], kernel) \
        else knn_neighbors_blocked
    return fn(x, radius, k)


def _batched(x) -> bool:
    """Whether ``x`` is a tensor batched by ``torch.func.vmap``."""
    return torch._C._functorch.is_batchedtensor(x)


class _KnnSelect(torch.autograd.Function):
    """:func:`knn_select`'s Function: forward the dispatch, backward a
    zero gradient for x (``pallas_knn._knn_select_bwd``), and a vmap rule
    that runs the mapped axis as the kernels' member axis — one launch for
    the whole batch."""

    @staticmethod
    def forward(x, radius, k, kernel):
        return _kernel_dispatch(x, radius, k, kernel)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x = inputs[0]
        ctx.x_meta = (x.shape, x.dtype, x.device)
        ctx.mark_non_differentiable(output[0], output[3])

    @staticmethod
    def backward(ctx, *grads):
        shape, dtype, device = ctx.x_meta
        return torch.zeros(shape, dtype=dtype, device=device), None, None, \
            None

    @staticmethod
    def vmap(info, in_dims, x, radius, k, kernel):
        x_dim, r_dim = in_dims[0], in_dims[1]
        if x_dim is None and r_dim is None:
            return _kernel_dispatch(x, radius, k, kernel), (None,) * 4
        if r_dim is not None:
            # A radius per member (the traced-config step): the kernels
            # read it as their radius array, B members at B radii.
            radius = radius.movedim(r_dim, 0)
            if radius.dim() != 1:
                raise ValueError(f"knn_select maps over a scalar radius, "
                                 f"got a batch of {tuple(radius.shape[1:])}")
        x = (x.expand((info.batch_size,) + tuple(x.shape)) if x_dim is None
             else x.movedim(x_dim, 0))
        if x.dim() != 3:
            raise ValueError(f"knn_select maps over (N, 2) positions, got a "
                             f"batch of {tuple(x.shape[1:])}")
        return _kernel_dispatch(x.contiguous(), radius, k, kernel), (0,) * 4


def knn_select(x, radius, k: int, kernel: str = "auto"):
    """The kernels as a SELECTION with a defined (zero) gradient
    (``pallas_knn.knn_select``): (idx, dist, nearest, count) of
    :func:`knn_neighbors` through the fused-vs-streaming dispatch.

    Under autograd the gradient it passes to x is zero — the true
    derivative of which neighbours are kept — and ``idx``/``count`` are
    non-differentiable; ``dist`` and ``nearest`` are values whose position
    gradient it drops, so a caller on a gradient path recomputes what it
    differentiates through ``idx`` (:func:`knn_gating_pallas_diff`).
    Under ``torch.func.vmap`` the mapped axis becomes the kernels' member
    axis: one launch for the batch."""
    return _KnnSelect.apply(x, radius, k, kernel)


def _gating_epilogue(states4, idx, dist, count, k: int):
    """(obs, mask, dropped) from a kernel selection."""
    mask = torch.isfinite(dist)
    obs = states4[idx.to(torch.int64)]
    dropped = torch.clamp(count - k, min=0)
    return obs, mask, dropped


def knn_gating_pallas(states4, radius, k: int, *, kernel: str = "auto"):
    """Drop-in for :func:`cbf_tpu_torch.rollout.gating.knn_gating` (all-row
    self-exclusion form) plus the nearest-any metric, through the kernels.

    Args: states4 (N, 4). Returns (obs (N, k, 4), mask (N, k),
    nearest_all (N,), dropped (N,) int32 — in-radius candidates beyond the
    k slots; callers surface it as StepOutputs.gating_dropped_count).

    Not differentiable: in the JAX package ``jax.grad`` through it fails
    (the raw kernel has no AD rule), and here a kernel output would be a
    silent constant, so it raises where autograd would need a gradient
    through it — use :func:`knn_gating_pallas_diff`."""
    if torch.is_grad_enabled() and states4.requires_grad:
        raise RuntimeError(
            "knn_gating_pallas has no gradient (the kernels' outputs are "
            "constants to autograd); differentiate through "
            "knn_gating_pallas_diff, which recomputes the gathered rows and "
            "the nearest distance from the positions")
    idx, dist, nearest, count = knn_select(states4[:, :2], radius, k,
                                           kernel)
    obs, mask, dropped = _gating_epilogue(states4, idx, dist, count, k)
    return obs, mask, nearest, dropped


def knn_gating_pallas_diff(states4, radius, k: int, *,
                           kernel: str = "auto"):
    """Differentiable twin of :func:`knn_gating_pallas`
    (``pallas_knn.knn_gating_pallas_diff``): the kernels select through
    :func:`knn_select`, torch gathers the slab and recomputes the gated
    nearest distance from the gathered positions (``safe_norm``: a
    coincident kept pair would otherwise NaN the gradient). The mask stays
    the kernels' (boolean, no gradient on any path).

    Returns (obs (N, k, 4), mask (N, k), nearest1 (N,) — the GATED top-1
    distance, inf when nothing is in radius, dropped (N,) int32)."""
    idx, dist, _, count = knn_select(states4[:, :2], radius, k, kernel)
    obs, mask, dropped = _gating_epilogue(states4, idx, dist, count, k)
    d = safe_norm(states4[:, None, :2] - obs[..., :2], dim=-1)
    nearest1 = torch.amin(torch.where(mask, d, torch.inf), dim=1)
    return obs, mask, nearest1, dropped


def knn_gating_banded(states4, radius, k: int, *, window_blocks: int):
    """Banded (O(N·W)) form of :func:`knn_gating_pallas`. Returns (obs
    (N, k, 4), mask (N, k), nearest_all (N,), overflow (N,) bool — rows
    whose y-band exceeded the window, dropped (N,) int32 — window-local
    in-radius candidates beyond the k slots)."""
    idx, dist, nearest, overflow, count = knn_neighbors_banded(
        states4[:, :2], radius, k, window_blocks=window_blocks)
    obs, mask, dropped = _gating_epilogue(states4, idx, dist, count, k)
    return obs, mask, nearest, overflow, dropped
