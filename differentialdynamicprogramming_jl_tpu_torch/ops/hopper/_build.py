"""Build and load the hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface. At first use each
``.cu`` file is compiled by its own ``nvcc`` process, all started together,
and the objects are linked into one shared library, loaded with
``ctypes``: seconds to build, where an extension that includes PyTorch's
headers takes minutes. The library lands in ``build/torch_kernels/`` at the
root of the checkout; its name carries a hash of the sources and flags, so
a stale library is never loaded.

No ``--use_fast_math``: the pendcart swing-up lives near θ≈π, where the
accurate ``sinf``/``cosf`` matter. ``--fmad=false`` keeps every multiply and
add separately rounded, in the operation order of the plain PyTorch
versions, so a kernel and its plain version differ only where the card's
``sinf``/``cosf`` and the host's differ. It also makes the α=0 retrace of
the line search reproduce a trajectory bit for bit, whichever kernel rolled
it out first.

A model written only in Python (``LanesModel(device=None)``), and a user's
derivative tiles without a descriptor, are lowered into a C++ struct
(:mod:`.lower`) and built into libraries of their own
(:func:`build_lowered`, :func:`lowered_library`): a generated ``.cu`` per
instance group (:data:`LOWERED_GROUPS`) includes ``csrc/lowered.cuh``, each
group one ``nvcc`` process and one ``.so`` whose name carries the digest of
the generated source, the headers and ``FLAGS``, so a model's first launch
compiles only the group it needs, and a model of the same structure reuses
it. K4 at a state size, and the packed K1 at an (n, m), that the kernel
library does not hold are built the same way, one library per size
(:func:`covariance_library`, :func:`packed_library`). K1's wide design
(``csrc/backward_wide.cuh``) is one library for every size
(:func:`wide_library`), which takes n and m at run time. K1's heaviest
instances of the autodiff sources are a library of their own too
(:func:`sources_library`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
# every source the library is built from, headers included, so that the
# library's hash changes with any of them; each .cu is one nvcc process
SOURCES = ("common.cuh", "ring.cuh", "autodiff.cuh", "pendcart.cuh",
           "lti.cuh", "quadrotor.cuh", "packed.cuh", "backward.cuh",
           "forward.cuh", "backward.cu", "backward_lti.cu",
           "backward_lti_gps.cu", "backward_lti_10_3.cu",
           "backward_lti_gps_10_3.cu", "backward_quad.cu",
           "backward_pendcart_ad.cu", "backward_pendcart_param.cu",
           "backward_packed.cu", "backward_packed_lti.cu", "backward_so.cu",
           "backward_quad_so.cu", "backward_pendcart_param_ad.cu",
           "backward_pendcart_gps.cu", "forward.cu", "forward_lti.cu",
           "forward_lti_10_3.cu", "forward_quad.cu",
           "forward_pendcart_param.cu", "covariance.cuh", "covariance.cu",
           "probe.cu")
# the sources library (sources_library): K1's Autodiff<LTI> instances at
# ⟨10,2⟩ and ⟨10,3⟩, first and second order, and Autodiff<Quadrotor, true>
# in GPS mode, with their own entry point (backward_sources.cu), built at
# their first launch: in the kernel library they made its build on the
# card's host ≈100 s against ≈50 s
SOURCE_LIBRARY = ("common.cuh", "ring.cuh", "autodiff.cuh", "lti.cuh",
                  "quadrotor.cuh", "backward.cuh", "backward_sources.cu",
                  "backward_lti_ad.cu", "backward_lti_ad_10_3.cu",
                  "backward_lti_ad_so.cu", "backward_lti_ad_so_10_3.cu",
                  "backward_quad_so_gps.cu")
# compile flags of every source; the objects are then linked with -shared
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")
# the headers a lowered model's libraries are built from, beside its
# generated struct (ops/hopper/lower.py)
LOWERED_HEADERS = ("common.cuh", "ring.cuh", "autodiff.cuh", "backward.cuh",
                   "forward.cuh", "lowered.cuh")
# the instance groups of a lowered model (its struct Lowered) and of a
# user's lowered derivative tiles (LoweredTiles; "t1*"), csrc/lowered.cuh
# DDP_LOWERED_GROUP; "fwd" has K3's and K2's entry points, the others K1's
LOWERED_GROUPS = {"fwd": 0, "k1": 1, "k1_gps": 2, "k1_so": 3, "t1": 4,
                  "t1_gps": 5, "t1_so": 6, "k1_so_gps": 7, "t1_so_gps": 8}
# the headers of the libraries generated for a size the kernel library is
# not built for: K4 at any n (covariance_library), the packed K1 at any
# (n, m) (packed_library)
COVARIANCE_HEADERS = ("common.cuh", "ring.cuh", "covariance.cuh")
PACKED_HEADERS = ("common.cuh", "ring.cuh", "backward.cuh", "packed.cuh")
# the headers of K1's wide library (wide_library)
WIDE_HEADERS = ("common.cuh", "ring.cuh", "backward.cuh", "backward_wide.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
CUDA_NVCC = Path("/usr/local/cuda/bin/nvcc")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argument types of the C entry points (csrc/*.cu): every pointer, the stream
# included, is c_void_p so that none is cut to 32 bits
# the trailing model arguments of K1/K2/K3: static limits [lo_0, hi_0, ...]
# (host), per-scenario limits (2m, B) or null, per-scenario parameters
# (P, B) or null, P, model id, n, m, descriptor, descriptor size, device,
# stream
_MODEL = (_P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P)
# the launch plan before the device (K1-K5): blocks, threads,
# steps a chunk, ring stages, shared bytes (plan.py)
_PLAN = (_I,) * 5
SIGNATURES = {
    # K1 takes three more arguments before the plan: whether its
    # derivatives are made by autodiff (the Autodiff<Body> instances),
    # whether they are second order (full DDP), and the m > 2 box QP's
    # iterations
    "ddp_backward_lanes": (_P, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                           _I) + _MODEL[:9] + (_I, _I, _I) + _PLAN
                          + _MODEL[9:],
    "ddp_forward_lanes": (_P, _I, _P, _I, _I, _I, _P, _P, _I, _P, _P, _P,
                          _I, _I) + _MODEL[:9] + _PLAN + _MODEL[9:],
    "ddp_linesearch_lanes": (_P, _I, _P, _I, _I, _I, _P, _P, _P, _I, _F, _P,
                             _P, _I, _I) + _MODEL[:9] + _PLAN + _MODEL[9:],
    # K4: fx, out, T, B, n, R1 (host), compute warps, staged stores
    "ddp_covariance_lanes": (_P, _P, _I, _I, _I, _P, _I, _I) + _PLAN
                            + (_I, _P),
    "ddp_probe_lanes": (_P, _P, _I, _I, _I, _I, _I, _F) + _PLAN + (_I, _P),
    # K1's wide design: traj, s_in, lam, prev, eta, out, s_out, stats, T,
    # B, emit, reg_type, use_limits, static limits (host), per-scenario
    # limits, n, m, the box QP's iterations, blocks, threads, shared bytes,
    # device, stream
    "ddp_backward_wide": (_P, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                          _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
}
# the entry points of the kernel library (csrc/*.cu); K1's wide design is
# a library of its own (wide_library)
LIBRARY_NAMES = tuple(name for name in SIGNATURES
                      if name != "ddp_backward_wide")


class Build(NamedTuple):
    path: Path
    seconds: float      # 0.0 when an up-to-date library was found
    log: str            # nvcc's output (ptxas register and spill report)


def find_nvcc() -> str:
    """Path of ``nvcc``; raises RuntimeError when the CUDA toolkit is absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_NVCC.is_file():
        return str(CUDA_NVCC)
    raise RuntimeError(
        "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc: the CUDA "
        "kernels of differentialdynamicprogramming_jl_tpu_torch are built "
        "from source at first use and need the CUDA toolkit")


def _digest(sources: Sequence[str]) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in sources:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(sources: Sequence[str] = SOURCES,
          prefix: str = "kernels") -> Build:
    """Compile ``sources`` (the kernel library's by default) unless an
    up-to-date library exists: one nvcc a ``.cu``, all started together,
    linked into ``libddp_<prefix>_<digest>.so``."""
    nvcc = find_nvcc()
    digest = _digest(sources)
    path = BUILD_DIR / f"libddp_{prefix}_{digest}.so"
    if path.is_file():
        return Build(path, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for name in sources:
        if name.endswith(".cu"):
            obj = BUILD_DIR / f"{Path(name).stem}.{tag}.o"
            proc = subprocess.Popen(
                [nvcc, *FLAGS, "-c", "-o", str(obj), str(CSRC / name)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((name, obj, proc))
    logs, failed = [], []
    for name, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode}):\n{out[-4000:]}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        r = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                            *map(str, objs)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({r.returncode}):\n{r.stderr[-4000:]}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, path)          # atomic: concurrent builds never race
    return Build(path, seconds, "".join(logs) + r.stdout + r.stderr)


def _bind(path: Path, names) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.ddp_error_string.argtypes = (ctypes.c_int,)
    lib.ddp_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once per process)."""
    return _bind(build().path, LIBRARY_NAMES)


@functools.lru_cache(maxsize=None)
def sources_library() -> ctypes.CDLL:
    """The loaded sources library (``SOURCE_LIBRARY``: K1's Autodiff<LTI>
    and GPS Autodiff<Quadrotor, true> instances), built first if needed."""
    return _bind(build(SOURCE_LIBRARY, "sources").path,
                 ("ddp_backward_lanes",))


def max_m_define(m: int) -> str:
    """The lines that build a generated library for m controls
    (``csrc/common.cuh`` DDP_MAX_M, with its loops rolled, DDP_ROLLED):
    none up to the kernel library's ``plan.LIBRARY_MAX_M``, so that such a
    library's source, and its bits, stay as they were. Every such library
    rolls: unrolled, nvcc took 241-537 s for a ⟨10,8⟩ or ⟨14,7⟩ library
    on the card's host (104-145 s rolled), and ⟨16,16⟩ ran a 96 GiB host
    out of memory."""
    from .plan import LIBRARY_MAX_M
    if m <= LIBRARY_MAX_M:
        return ""
    return f"#define DDP_MAX_M {m}\n#define DDP_ROLLED 1\n"


def lowered_source(struct: str, group: str) -> str:
    """The generated ``.cu`` of one instance group of a lowered model, built
    for the struct's own m."""
    m = int(re.search(r"static constexpr int M = (\d+);", struct).group(1))
    return (f"// A lowered model's instance group {group!r}, generated by "
            "ops/hopper/_build.py.\n"
            f"#define DDP_LOWERED_GROUP {LOWERED_GROUPS[group]}\n"
            f"{max_m_define(m)}"
            '#include "autodiff.cuh"\n\nnamespace ddp {\n\n'
            f"{struct}\n}}  // namespace ddp\n\n"
            '#include "lowered.cuh"\n')


def _generated_path(source: str, headers: Sequence[str],
                    prefix: str) -> Path:
    """The library of a generated source: its name carries the digest of
    the source, the headers it includes and ``FLAGS``."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in headers:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(source.encode())
    return BUILD_DIR / f"libddp_{prefix}_{h.hexdigest()[:16]}.so"


def build_generated(jobs: Sequence[Tuple[str, Sequence[str], str]],
                    what: str = "a generated library") -> list:
    """Build the libraries of ``jobs``, (source, headers, name prefix)
    triples, that are not up to date: one ``nvcc`` process each, all
    started together. Returns a :class:`Build` per job (seconds 0.0 for
    one found built)."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = [None] * len(jobs), []
    for i, (source, headers, prefix) in enumerate(jobs):
        path = _generated_path(source, headers, prefix)
        if path.is_file():
            out[i] = Build(path, 0.0, "")
            continue
        tag = f"{os.getpid()}.{i}"
        cu = path.with_suffix(f".{tag}.cu")
        cu.write_text(source)
        tmp = path.with_suffix(f".{tag}.tmp")
        proc = subprocess.Popen(
            [nvcc, *FLAGS, "-shared", "-I", str(CSRC), "-o", str(tmp),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        procs.append((i, path, cu, tmp, proc, time.perf_counter()))

    def finish(job):
        """(job, log, its own seconds): each process waited for in a
        thread of its own, so that its time is its own."""
        log, _ = job[4].communicate()
        return job, log, time.perf_counter() - job[5]

    with ThreadPoolExecutor(max(len(procs), 1)) as pool:
        done = list(pool.map(finish, procs))
    failed = []
    for (i, path, cu, tmp, proc, _), log, seconds in done:
        cu.unlink(missing_ok=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(
                f"{jobs[i][2]} ({proc.returncode}):\n{log[-4000:]}")
            continue
        os.replace(tmp, path)      # atomic: concurrent builds never race
        out[i] = Build(path, seconds, log)
    if failed:
        raise RuntimeError(f"nvcc failed on {what}: " + "\n".join(failed))
    return out


def _lowered_path(source: str) -> Path:
    """The library of a lowered model's generated source."""
    return _generated_path(source, LOWERED_HEADERS, "lowered")


def build_lowered(jobs: Sequence[Tuple[str, str]]) -> list:
    """Build the libraries of ``jobs``, (struct, group) pairs, that are not
    up to date (:func:`build_generated`)."""
    return build_generated(
        [(lowered_source(struct, group), LOWERED_HEADERS, "lowered")
         for struct, group in jobs], "a lowered model's library")


def lowered_library(struct: str, group: str) -> ctypes.CDLL:
    """The loaded library of instance group ``group`` of the lowered struct
    ``struct``, built first if needed (ops/hopper/lower.py keeps it)."""
    (built,) = build_lowered([(struct, group)])
    return _bind(built.path, ("ddp_forward_lanes", "ddp_linesearch_lanes")
                 if group == "fwd" else ("ddp_backward_lanes",))


ERROR_STRING = """
extern "C" const char* ddp_error_string(int code) {
  if (code == ddp::ERR_MODEL)
    return "this generated library holds no instance for these arguments";
  if (code == ddp::ERR_ARGS) return "arguments outside what the kernel takes";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


def covariance_source(ns: Sequence[int]) -> str:
    """The generated ``.cu`` of K4 at the state sizes ``ns`` (none of
    them 4, 6 or 10), each with the block plan.py derives from n
    (``plan.cov_shape``): the ring kernel, or the device-memory one.
    ``ddp_covariance_lanes`` has the kernel library's signature; its
    ``stage`` argument is the plan's Σ mode."""
    from .plan import COV_GLOBAL, cov_shape
    lines = [f"// K4 at n in {tuple(ns)}, generated by ops/hopper/_build.py.",
             '#include "covariance.cuh"', "",
             'extern "C" int ddp_covariance_lanes(const float* fx, float* out,'
             " int T, int B, int n, const float* r1, int warps, int stage, "
             "int blocks, int threads, int tc, int stages, int smem, "
             "int device, void* stream) {",
             "  using namespace ddp;",
             "  if (T < 1 || B < 1) return ERR_ARGS;",
             "  cudaSetDevice(device);",
             "  cudaStream_t st = static_cast<cudaStream_t>(stream);",
             "  const RingPlan p{blocks, threads, tc, stages, smem};"]
    for n in ns:
        shape = cov_shape(n)
        cond = f"n == {n} && warps == {shape.warps} && stage == {shape.sigma}"
        call = (f"launch_covariance_global<{n}, {shape.warps}>(fx, out, T, "
                "B, p, st)" if shape.sigma == COV_GLOBAL else
                f"launch_covariance<{n}, {shape.warps}, "
                f"{'true' if shape.sigma else 'false'}>(fx, out, T, B, r1, "
                "p, st)")
        lines += [f"  if ({cond})", f"    return {call};"]
    lines += ["  return ERR_ARGS;", "}", ERROR_STRING]
    return "\n".join(lines)


def packed_source(n: int, m: int) -> str:
    """The generated ``.cu`` of K1's packed-derivatives instance
    ``Packed<n, m>`` (csrc/packed.cuh) in ``"gains"`` and ``"full"``
    emission without GPS mode, built for its own m; ``ddp_backward_lanes``
    has the kernel library's signature and returns ERR_MODEL for anything
    else."""
    lines = [f"// K1's packed instance Packed<{n}, {m}>, generated by "
             f"ops/hopper/_build.py.\n{max_m_define(m)}".rstrip("\n"),
             '#include "backward.cuh"', '#include "packed.cuh"', "",
             'extern "C" int ddp_backward_lanes(const float* traj, int s_in, '
             "const float* lam, const float* prev, const float* eta, "
             "float* out, int s_out, float* stats, int T, int B, int emit, "
             "int reg_type, int use_limits, const float* lims, "
             "const float* lims_lanes, const float* params, int n_params, "
             "int model_id, int n, int m, const float* consts, int n_consts, "
             "int autodiff, int second_order, int qp_iters, int blocks, "
             "int threads, int tc, int stages, int smem, int device, "
             "void* stream) {",
             "  using namespace ddp;",
             "  BwdArgs a;",
             "  const int rc = bwd_args(traj, s_in, lam, prev, eta, out, "
             "s_out, stats, T, B, emit, reg_type, use_limits, lims, "
             "lims_lanes, params, n_params, n, m, consts, qp_iters, blocks, "
             "threads, tc, stages, smem, stream, a);",
             "  if (rc != 0) return rc;",
             "  if (model_id != 0 || autodiff || second_order || n_params != 0"
             " || n_consts != 0 || prev != nullptr)",
             "    return ERR_MODEL;",
             "  cudaSetDevice(device);",
             f"  if (n != {n} || m != {m}) return ERR_MODEL;",
             f"  using Model = Packed<{n}, {m}>;",
             "  switch (a.emit) {",
             "    case EMIT_GAINS: return launch_one<Model, EMIT_GAINS, false>(a);",
             "    case EMIT_FULL: return launch_one<Model, EMIT_FULL, false>(a);",
             "    default: return ERR_MODEL;",
             "  }", "}", ERROR_STRING]
    return "\n".join(lines)


def wide_source() -> str:
    """The ``.cu`` of K1's wide library (csrc/backward_wide.cuh), built for
    m up to ``plan.MAX_CONTROLS``: ``ddp_backward_wide``."""
    from .plan import MAX_CONTROLS
    return "\n".join([
        "// K1's wide design, generated by ops/hopper/_build.py.",
        max_m_define(MAX_CONTROLS).rstrip("\n"),
        '#include "backward_wide.cuh"', "",
        'extern "C" int ddp_backward_wide(const float* traj, int s_in, '
        "const float* lam, const float* prev, const float* eta, float* out, "
        "int s_out, float* stats, int T, int B, int emit, int reg_type, "
        "int use_limits, const float* lims, const float* lims_lanes, int n, "
        "int m, int qp_iters, int blocks, int threads, int smem, "
        "int device, void* stream) {",
        "  cudaSetDevice(device);",
        "  return ddp::launch_backward_wide(traj, s_in, lam, prev, eta, out, "
        "s_out, stats, T, B, emit, reg_type, use_limits, lims, lims_lanes, "
        "n, m, qp_iters, blocks, threads, smem, "
        "static_cast<cudaStream_t>(stream));", "}", ERROR_STRING])


def wide_job() -> tuple:
    """The (source, headers, prefix) job of K1's wide library."""
    return wide_source(), WIDE_HEADERS, "wide"


@functools.lru_cache(maxsize=None)
def wide_library() -> ctypes.CDLL:
    """The loaded library of K1's wide design, built first if needed (one
    for every size)."""
    (built,) = build_generated([wide_job()], "the wide K1")
    return _bind(built.path, ("ddp_backward_wide",))


def covariance_job(ns: Sequence[int]) -> tuple:
    """The (source, headers, prefix) job of K4's library at ``ns``."""
    return covariance_source(ns), COVARIANCE_HEADERS, "covariance"


def packed_job(n: int, m: int) -> tuple:
    """The (source, headers, prefix) job of the packed K1's library at
    ⟨n,m⟩."""
    return packed_source(n, m), PACKED_HEADERS, "packed"


@functools.lru_cache(maxsize=None)
def covariance_library(n: int) -> ctypes.CDLL:
    """The loaded K4 library of state size n (not 4, 6 or 10), built first
    if needed: one per n, so that a launch compiles only its own size."""
    (built,) = build_generated([covariance_job((n,))], f"K4 at n={n}")
    return _bind(built.path, ("ddp_covariance_lanes",))


@functools.lru_cache(maxsize=None)
def packed_library(n: int, m: int) -> ctypes.CDLL:
    """The loaded library of the packed K1 at (n, m), built first if
    needed."""
    (built,) = build_generated([packed_job(n, m)],
                               f"the packed K1 at <{n},{m}>")
    return _bind(built.path, ("ddp_backward_lanes",))


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point reported an error (its cudaGetLastError,
    or a negative code for arguments the launcher refused)."""
    if rc != 0:
        raise RuntimeError(
            f"{what}: kernel launch failed ({rc}): "
            f"{lib.ddp_error_string(rc).decode()}")
