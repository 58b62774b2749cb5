"""Solver export and serving (``utils/aot.py``), on CPU tensors: the
port's counterpart of ``tests/test_aot.py``.

The artifact is a recipe (the recorded solver entry and how to rebuild its
arguments) with the constant tensors, so the served call runs the same
code on the same inputs: its result must equal the direct call's bit for
bit and be the entry's own result type. Beyond the JAX package's four
tests: the artifact served in a fresh process that never defined the
closure, the refusals of what cannot be rebuilt, and the proof that the
artifact holds no pickle."""
import io
import os
import pathlib
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from differentialdynamicprogramming_jl_tpu_torch.models.pendcart import (
    PendCartSpec, default_x0, make_pendcart_problem, pendcart_derivs_tiles,
    pendcart_lanes)
from differentialdynamicprogramming_jl_tpu_torch.ops.hopper.forward_kernel \
    import LanesModel
from differentialdynamicprogramming_jl_tpu_torch.parallel.mesh import (
    ilqg_batched)
from differentialdynamicprogramming_jl_tpu_torch.solvers.batch import (
    BatchILQGResult, ilqg_batch_lanes)
from differentialdynamicprogramming_jl_tpu_torch.solvers.ilqg import (
    ILQGConfig, ILQGResult, default_alphas)
from differentialdynamicprogramming_jl_tpu_torch.utils.aot import (
    deserialize_solver, export_solver, load_solver, save_solver,
    serialize_solver)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                 lam_max=1e15, max_iter=5)


def _x0s(B, dtype):
    g = torch.Generator().manual_seed(0)
    return (default_x0(dtype, "cpu")[None, :]
            + 0.1 * torch.randn((B, 4), generator=g, dtype=dtype))


@pytest.fixture(scope="module")
def generic():
    """The JAX test's generic solve: ``ilqg_batched`` on the pendcart with
    autodiff derivatives, ±5, B=3, T=11, f64; its direct result and its
    artifact."""
    dtype = torch.float64
    problem = make_pendcart_problem(PendCartSpec(), derivs="autodiff",
                                    dtype=dtype, device="cpu")
    lims = torch.tensor([[-5.0, 5.0]], dtype=dtype)

    def solve(x0s, u0s):
        return ilqg_batched(problem, x0s, u0s, lims=lims, cfg=CFG)

    x0s, u0s = _x0s(3, dtype), torch.zeros((3, 11, 1), dtype=dtype)
    blob = serialize_solver(solve, x0s, u0s)
    return solve, x0s, u0s, solve(x0s, u0s), blob


def _lanes_solve():
    model = pendcart_lanes(PendCartSpec())
    tiles = pendcart_derivs_tiles(PendCartSpec())

    def solve(x0s, u0s):
        return ilqg_batch_lanes(model, None, x0s, u0s, lims=((-5.0, 5.0),),
                                cfg=CFG, derivs_tiles=tiles, max_steps=3,
                                kt_backward=2, kt_forward=2, interpret=True)

    return solve, _x0s(8, torch.float32), torch.zeros((8, 9, 1))


def _leaves(tree):
    return [a for a in torch.utils._pytree.tree_leaves(tree)
            if a is not None]


def _assert_same(direct, served):
    la, lb = _leaves(direct), _leaves(served)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def test_generic_tier_roundtrip_bit_exact(generic):
    _, x0s, u0s, direct, blob = generic
    assert isinstance(blob, bytes) and len(blob) > 0
    served = deserialize_solver(blob)(x0s, u0s)
    assert isinstance(served, ILQGResult)
    _assert_same(direct, served)


def test_save_load_file_roundtrip(tmp_path, generic):
    solve, x0s, u0s, direct, _ = generic
    path = tmp_path / "solver.bin"
    save_solver(path, solve, x0s, u0s)
    assert path.stat().st_size > 0
    served = load_solver(path)(x0s, u0s)
    assert torch.equal(direct.cost, served.cost)


def test_artifact_pins_shapes(generic):
    _, x0s, u0s, _, blob = generic
    serve = deserialize_solver(blob)
    with pytest.raises(ValueError, match="(?i)shape|dimension|mismatch"):
        serve(torch.cat([x0s, x0s]), torch.cat([u0s, u0s]))
    with pytest.raises(ValueError, match="mismatch"):
        serve(x0s.float(), u0s)


def test_lane_tier_roundtrip_bit_exact():
    """The lane solver (the kernels' plain versions on CPU tensors)
    exports and serves bit for bit, returning a BatchILQGResult."""
    solve, x0s, u0s = _lanes_solve()
    direct = solve(x0s, u0s)
    served = deserialize_solver(serialize_solver(solve, x0s, u0s))(x0s, u0s)
    assert isinstance(served, BatchILQGResult)
    _assert_same(direct, served)


SERVE = """
import sys
import numpy as np
import torch
from differentialdynamicprogramming_jl_tpu_torch.utils.aot import load_solver
d = sys.argv[1]
args = [torch.from_numpy(np.load(f"{d}/arg{i}.npy")) for i in range(2)]
res = load_solver(f"{d}/solver.bin")(*args)
print(type(res).__name__)
np.save(f"{d}/cost_total.npy", res.cost_total.numpy())
np.save(f"{d}/u.npy", res.u.numpy())
np.save(f"{d}/reason.npy", res.reason.numpy())
"""


def test_served_in_a_process_without_the_closure(tmp_path):
    """The lane-tier artifact, loaded and called in a fresh interpreter
    that imports only the port's aot module: the same result bits."""
    solve, x0s, u0s = _lanes_solve()
    save_solver(tmp_path / "solver.bin", solve, x0s, u0s)
    for i, a in enumerate((x0s, u0s)):
        np.save(tmp_path / f"arg{i}.npy", a.numpy())
    r = subprocess.run([sys.executable, "-c", SERVE, str(tmp_path)],
                       cwd=str(ROOT), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "BatchILQGResult"
    direct = solve(x0s, u0s)
    for k in ("cost_total", "u", "reason"):
        np.testing.assert_array_equal(np.load(tmp_path / f"{k}.npy"),
                                      getattr(direct, k).numpy())


def test_refuses_what_it_cannot_rebuild():
    """No recorded entry, two, a result that is not the entry's, a model
    the factories did not make, a non-tensor example argument: each a
    TypeError that says what can be exported."""
    solve, x0s, u0s = _lanes_solve()
    with pytest.raises(TypeError, match="recorded solver entries"):
        export_solver(lambda a, b: a + 1.0, x0s, u0s)
    with pytest.raises(TypeError, match="2 recorded"):
        export_solver(lambda a, b: (solve(a, b), solve(a, b))[0], x0s, u0s)
    with pytest.raises(TypeError, match="something other"):
        export_solver(lambda a, b: solve(a, b).cost_total, x0s, u0s)
    m = pendcart_lanes(PendCartSpec())
    own = LanesModel(n=4, m=1, dynamics=m.dynamics, cost=m.cost,
                     terminal=m.terminal)
    with pytest.raises(TypeError, match="cannot be rebuilt.*factories"):
        export_solver(lambda a, b: ilqg_batch_lanes(
            own, None, a, b, lims=((-5.0, 5.0),), cfg=CFG,
            derivs_tiles=pendcart_derivs_tiles(PendCartSpec()),
            max_steps=1), x0s, u0s)
    with pytest.raises(TypeError, match="not a tensor"):
        export_solver(lambda a, b: solve(x0s, u0s), x0s.numpy(), u0s)


def test_artifact_holds_no_pickle(generic):
    """Every member of the artifact is a plain array that loads with
    pickling refused, and none holds Python objects; the recipe is JSON."""
    blob = generic[-1]
    names = zipfile.ZipFile(io.BytesIO(blob)).namelist()
    assert "__recipe__.npy" in names
    assert all(n.endswith(".npy") for n in names)
    with np.load(io.BytesIO(blob), allow_pickle=False) as data:
        for k in data.files:
            assert data[k].dtype != object
        import json
        recipe = json.loads(bytes(data["__recipe__"]).decode())
    assert recipe["entry"] == "parallel.mesh.ilqg_batched"
    assert recipe["examples"] == [
        {"shape": [3, 4], "dtype": "float64"},
        {"shape": [3, 11, 1], "dtype": "float64"}]
    assert recipe["arguments"]["problem"]["factory"] == \
        "models.pendcart.make_pendcart_problem"
    assert b"pickle" not in blob and b"\x80\x04\x95" not in blob
    assert os.path.basename(__file__) not in blob.decode("latin-1")
