"""The port as a package: it never loads JAX, its kernel build refuses to
run without nvcc, and its converter carries the JAX side's configs."""
import os
import pathlib
import subprocess
import sys

import pytest

import differentialdynamicprogramming_jl_tpu as J
from differentialdynamicprogramming_jl_tpu.models import pendcart as jpc
from differentialdynamicprogramming_jl_tpu_torch import convert
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import _build
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.backward_kernel \
    import OutLayout

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "differentialdynamicprogramming_jl_tpu_torch"


def test_port_does_not_load_jax():
    code = ("import sys\n"
            "import differentialdynamicprogramming_jl_tpu_torch as p\n"
            "import differentialdynamicprogramming_jl_tpu_torch.convert\n"
            "from differentialdynamicprogramming_jl_tpu_torch.solvers.batch "
            "import ilqg_batch_lanes\n"
            "from differentialdynamicprogramming_jl_tpu_torch.solvers"
            ".batch_kl import ilqgkl_batch_lanes, gps_rollout_lanes\n"
            "from differentialdynamicprogramming_jl_tpu_torch.ops.hopper"
            ".covariance_kernel import covariance_lanes\n"
            "from differentialdynamicprogramming_jl_tpu_torch.problem "
            "import Problem, broadcast_derivs\n"
            "from differentialdynamicprogramming_jl_tpu_torch.models.linear "
            "import LTISpec, random_lti, make_lti_problem, lti_lanes, "
            "lti_derivs_tiles\n"
            "from differentialdynamicprogramming_jl_tpu_torch.device "
            "import as_tensor, resolve\n"
            "from differentialdynamicprogramming_jl_tpu_torch.models"
            ".quadrotor import QuadrotorSpec, quadrotor_lanes, "
            "make_quadrotor_problem, default_x0\n"
            "from differentialdynamicprogramming_jl_tpu_torch.ops.hopper"
            ".autodiff_tiles import autodiff_derivs_tiles, "
            "autodiff_packed_derivs\n"
            "from differentialdynamicprogramming_jl_tpu_torch.problem "
            "import make_autodiff_derivs\n"
            "from differentialdynamicprogramming_jl_tpu_torch.ops.hopper "
            "import _build\n"
            "from differentialdynamicprogramming_jl_tpu_torch.ops import "
            "boxqp, backward, forward, kl, riccati_scan\n"
            "from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg "
            "import ilqg, solve_batch\n"
            "from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqgkl "
            "import ilqg_kl\n"
            "from differentialdynamicprogramming_jl_tpu_torch.parallel.mesh "
            "import ilqg_batched, make_mesh, ilqg_sharded, "
            "ilqg_batch_sharded, ilqgkl_batch_sharded\n"
            "from differentialdynamicprogramming_jl_tpu_torch.parallel "
            "import distributed\n"
            "from differentialdynamicprogramming_jl_tpu_torch.solvers.fleet "
            "import ilqg_fleet, ilqgkl_fleet, ilqg_fleet_sharded, "
            "ilqgkl_fleet_sharded\n"
            "from differentialdynamicprogramming_jl_tpu_torch.utils "
            "import printing, aot, serialization, profiling, plotting\n"
            "from differentialdynamicprogramming_jl_tpu_torch import demos\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "print(p.__version__)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == J.__version__
    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            assert not line.lstrip().startswith(("import jax", "from jax")), \
                (path, line)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "CUDA_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library()
    assert not (tmp_path / "build").exists()


def test_kernel_sources_and_signatures():
    for name in _build.SOURCES + _build.SOURCE_LIBRARY:
        text = (_build.CSRC / name).read_text()
        assert "use_fast_math" not in text
    # K1's wide design is a library of its own, its entry point in the
    # source _build generates for it
    texts = [(_build.CSRC / s).read_text() for s in _build.SOURCES]
    texts.append(_build.wide_source())
    for name in _build.SIGNATURES:
        assert any(f'extern "C" int {name}(' in text for text in texts), name
    # the sources library (K1's heaviest autodiff instances, built at
    # their first launch) has K1's entry point, with the kernel library's
    # arguments
    entry = (_build.CSRC / "backward_sources.cu").read_text()
    assert 'extern "C" int ddp_backward_lanes(' in entry
    assert all(name in _build.SOURCE_LIBRARY for name in (
        "backward_lti_ad.cu", "backward_lti_ad_10_3.cu",
        "backward_lti_ad_so.cu", "backward_lti_ad_so_10_3.cu",
        "backward_quad_so_gps.cu"))
    assert not {n for n in _build.SOURCE_LIBRARY
                if n.endswith(".cu")} & set(_build.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in _build.FLAGS
    assert "--use_fast_math" not in _build.FLAGS
    # the build directory is one .gitignore lists
    rel = _build.BUILD_DIR.relative_to(ROOT)
    ignored = (ROOT / ".gitignore").read_text().split()
    assert rel.parts[0] + "/" in ignored or f"{rel}/" in ignored


def test_public_names_match_jax():
    """The port exports the JAX package's names for what it covers."""
    import differentialdynamicprogramming_jl_tpu_torch as P
    for name in P.__all__:
        assert hasattr(P, name), name
    from differentialdynamicprogramming_jl_tpu.solvers import batch_kl
    from differentialdynamicprogramming_jl_tpu.models import linear as jl
    for name in ("ILQGKLConfig", "ilqgkl_batch_lanes", "gps_rollout_lanes",
                 "BatchKLResult", "BatchKLTrace", "kl_div_wiki_lanes",
                 "calc_eta_lanes", "Problem", "make_pendcart_problem",
                 "broadcast_derivs", "LTISpec", "random_lti",
                 "make_lti_problem", "lti_lanes", "lti_derivs_tiles",
                 "SimpleLTVModel", "forward_covariance",
                 "make_autodiff_derivs", "autodiff_derivs_tiles"):
        assert name in P.__all__, name
        assert any(hasattr(mod, name) for mod in (J, batch_kl, jpc, jl)), \
            name


def test_missing_public_names():
    """The JAX names the port does not have: none. Each resolves to a
    module of the port, the five solver-export names included."""
    import differentialdynamicprogramming_jl_tpu_torch as P
    assert set(J.__all__) - set(P.__all__) == set()
    for name in ("ilqg", "ilqg_kl", "boxqp", "parallel_riccati", "Trace",
                 "sym", "KLTerms", "adam_update", "ilqg_fleet",
                 "ilqg_fleet_sharded", "ilqgkl_fleet",
                 "ilqgkl_fleet_sharded", "export_solver", "serialize_solver",
                 "deserialize_solver", "save_solver", "load_solver"):
        assert getattr(P, name).__module__.startswith(
            "differentialdynamicprogramming_jl_tpu_torch"), name


def test_out_layout_matches_jax():
    from differentialdynamicprogramming_jl_tpu.ops.pallas.backward_kernel \
        import OutLayout as JOut
    for n, m in ((4, 1), (10, 2)):
        for emit in ("full", "gains", "policy"):
            a, b = OutLayout(n, m, emit), JOut(n, m, emit)
            for name in ("k", "K", "Vx", "Vxx", "quu", "quui", "S"):
                assert getattr(a, name) == getattr(b, name), (emit, name)
    # the LTI streams of the fleet path: 22 gain slots, 140 in full
    assert OutLayout(10, 2, "gains").S == 22
    assert OutLayout(10, 2, "full").S == 140


def test_convert_configs_from_jax():
    jcfg = J.ILQGConfig(alphas=J.default_alphas(0.2, -3.0, 6), reg_type=2,
                        lam_max=1e15, iter_cap=40)
    cfg = convert.config_from_jax(jcfg)
    assert cfg.alphas == jcfg.alphas and cfg.cap() == jcfg.cap() == 40
    assert (cfg.reg_type, cfg.lam_max) == (2, 1e15)
    spec = convert.spec_from_jax(jpc.PendCartSpec(R=0.5))
    assert spec.R == 0.5 and spec.Q == (10.0, 1.0, 2.0, 1.0)


def test_autodiff_exports_match_jax_and_quadrotor_stays_in_its_module():
    """make_autodiff_derivs and autodiff_derivs_tiles are top-level names in
    both packages (JAX ``__init__.py:23,39,48,63``); the quadrotor's names
    stay in ``models/quadrotor.py``, where the JAX package keeps them."""
    import differentialdynamicprogramming_jl_tpu_torch as P
    from differentialdynamicprogramming_jl_tpu_torch.models import quadrotor
    for name in ("make_autodiff_derivs", "autodiff_derivs_tiles"):
        assert name in P.__all__ and name in J.__all__, name
    for name in ("QuadrotorSpec", "quadrotor_lanes", "make_quadrotor_problem",
                 "default_x0"):
        assert hasattr(quadrotor, name), name
        assert name not in P.__all__ or name == "default_x0", name
        assert name not in J.__all__ or name == "default_x0", name
    # every CUDA source the library is built from is hashed, the new ones
    # included
    for name in ("autodiff.cuh", "quadrotor.cuh", "backward_quad.cu",
                 "backward_pendcart_ad.cu", "forward_quad.cu"):
        assert name in _build.SOURCES, name
