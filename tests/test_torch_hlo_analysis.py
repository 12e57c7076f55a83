"""The port's cost counter (``repro_torch/launch/hlo_analysis.py``)
against the reference's HLO analysis (``repro/launch/hlo_analysis.py``).

The reference's five cases (``tests/test_hlo_analysis.py``) with Python
loops in place of scans, each FLOP count equal to the reference's
``analyze`` of the same JAX function on the same shapes: exactly 2·256³
per product, times the repeats (the reference multiplies a scan body by
its trip count; the port counts each iteration as it runs). Then what
has no reference case: the bytes of one ``mm``, a view chain and window
reads; the peak of live storages (a view counted once); the raise when a
kernel's launch counter moves; and, in a subprocess, the collectives'
bytes: on a one-rank gloo group a functional all-gather and
``dist.all_gather``'s c10d op, each its result's bytes; a one-rank mesh
gathers nothing, so a ``DTensor.full_tensor()`` on a fake group of 4
ranks, whose all-gather counts its result's bytes.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.hlo_analysis import analyze as ref_analyze
from repro_torch.launch.hlo_analysis import (COLLECTIVE_OPS, analyze,
                                             collective_kind)

ROOT = Path(__file__).resolve().parents[1]
W = jax.ShapeDtypeStruct((256, 256), jnp.float32)
X = jax.ShapeDtypeStruct((256, 256), jnp.float32)
MM = 2 * 256 ** 3
MM_BYTES = 3 * 256 * 256 * 4          # two operands and the result


def _ref_flops(fn):
    return ref_analyze(jax.jit(fn).lower(W, X).compile().as_text())["flops"]


def _inputs():
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.standard_normal((256, 256), np.float32)),
            torch.from_numpy(rng.standard_normal((256, 256), np.float32)))


def _port(fn):
    return analyze(fn, *_inputs())[1]


def test_single_dot():
    assert _port(lambda w, x: x @ w)["flops"] == MM
    assert _ref_flops(lambda w, x: x @ w) == MM


def test_loop_counts_every_iteration():
    def f(w, x):
        for _ in range(9):
            x = x @ w
        return x

    def g(w, x):
        y, _ = jax.lax.scan(lambda c, _: (c @ w, None), x, None, length=9)
        return y
    assert _port(f)["flops"] == _ref_flops(g) == 9 * MM


def test_nested_loops():
    def f(w, x):
        for _ in range(3):
            for _ in range(4):
                x = x @ w
        return x

    def g(w, x):
        def outer(c, _):
            c, _ = jax.lax.scan(lambda c2, _: (c2 @ w, None), c, None,
                                length=4)
            return c, None
        y, _ = jax.lax.scan(outer, x, None, length=3)
        return y
    assert _port(f)["flops"] == _ref_flops(g) == 12 * MM


def test_backward_flops_exceed_forward():
    """The gradient with respect to x: the forward's two products and
    two transposed ones, as the reference counts."""
    def plain_loss(w, x):
        return ((torch.tanh(x @ w) @ w) ** 2).sum()

    def grad_x(w, x):
        x = x.detach().requires_grad_()
        return torch.autograd.grad(plain_loss(w, x), x)[0]

    def ref_loss(w, x):
        return ((jnp.tanh(x @ w) @ w) ** 2).sum()
    fwd, bwd = _port(plain_loss)["flops"], _port(grad_x)["flops"]
    assert bwd >= 1.9 * fwd
    assert fwd == _ref_flops(ref_loss) == 2 * MM
    assert bwd == _ref_flops(
        lambda w, x: jax.grad(ref_loss, argnums=1)(w, x)) == 4 * MM


def test_bytes_scale_with_repeats():
    def f(w, x):
        for _ in range(7):
            x = torch.tanh(x @ w)
        return x
    a1 = _port(lambda w, x: torch.tanh(x @ w))
    a7 = _port(f)
    assert a7["bytes"] > 4 * a1["bytes"]
    assert a7["bytes"] == 7 * a1["bytes"]        # each iteration its ops


def test_bytes_of_one_mm_and_a_view_chain():
    c = _port(lambda w, x: x @ w)
    assert c["bytes"] == MM_BYTES and c["bytes_by_op"] == {"mm": MM_BYTES}
    views = _port(lambda w, x: x.view(-1).view(256, 256).t().transpose(0, 1)
                  .unsqueeze(0).squeeze(0)[3:].detach())
    assert views["bytes"] == 0 and views["flops"] == 0 and views["ops"] > 5
    assert all(v["count"] == 0 for k, v in views["coll"].items()
               if k in COLLECTIVE_OPS)


def test_window_reads_and_writes():
    """A gather counts twice the window it reads, an index_copy_ twice
    the window it writes, a copy_ its source and destination."""
    table = torch.zeros(1000, 64)
    idx = torch.arange(10)

    def f(table, idx):
        rows = table.index_select(0, idx)            # 10 x 64 read
        table.index_copy_(0, idx, rows * 2)           # 10 x 64 written
        table[:5].copy_(rows[:5])                     # 5 x 64 copied
        return rows
    c = analyze(f, table, idx)[1]
    row = 64 * 4
    assert c["bytes_by_op"]["index_select"] == 2 * 10 * row
    assert c["bytes_by_op"]["index_copy_"] == 2 * 10 * row
    assert c["bytes_by_op"]["copy_"] == 2 * 5 * row
    assert c["bytes_by_op"]["mul"] == 2 * 10 * row


def test_peak_counts_distinct_storages():
    x = torch.zeros(1024)                            # 4 KiB

    def f(x):
        v = x.view(32, 32)                           # the same storage
        y = v + 1
        z = y * 2
        del y
        w = z + 1                                    # y freed: reused room
        return w
    c = analyze(f, x)[1]
    assert c["argument_bytes"] == 4096
    assert c["peak_bytes"] == 3 * 4096               # x, y, z


def test_kernel_launch_during_the_run_raises():
    from repro_torch.kernels.launches import count_launch
    from repro_torch.kernels.wkv6 import wkv6
    before = wkv6.launches
    try:
        with pytest.raises(RuntimeError, match="wkv6"):
            analyze(lambda: count_launch(wkv6))
    finally:
        wkv6.launches = before


@pytest.mark.parametrize("name,kind", [
    ("all_gather_into_tensor", "all-gather"), ("allgather_", "all-gather"),
    ("reduce_scatter_tensor", "reduce-scatter"), ("all_reduce", "all-reduce"),
    ("allreduce_", "all-reduce"), ("all_to_all_single", "all-to-all"),
    ("wait_tensor", None)])
def test_collective_kinds(name, kind):
    assert collective_kind(name) == kind


def test_unknown_collective_raises():
    with pytest.raises(NotImplementedError):
        collective_kind("broadcast_")


COLLECTIVES = """
import torch, torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.hlo_analysis import analyze
dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
x = torch.ones(64, 32)
out, c = analyze(lambda x: funcol.all_gather_tensor(x, 0, dist.group.WORLD)
                 .wait(), x)
ag = c["coll"]["all-gather"]
assert ag["count"] == 1 and ag["bytes"] == out.numel() * 4 == 8192, c
parts = [torch.empty(64, 32)]
_, c = analyze(lambda x: dist.all_gather(parts, x), x)
assert c["coll"]["all-gather"]["count"] == 1, c
assert c["coll"]["all-gather"]["bytes"] == 8192, c
dist.destroy_process_group()
# a one-rank mesh gathers nothing: DTensor's all-gather on a fake 4
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
d = distribute_tensor(torch.ones(64, 32), mesh, [Shard(0)],
                      src_data_rank=None)
out, c = analyze(lambda d: d.full_tensor(), d)
ag = c["coll"]["all-gather"]
assert ag["count"] == 1 and ag["bytes"] == out.numel() * 4 == 8192, c
assert c["coll"]["total_bytes"] == 8192 and c["argument_bytes"] == 2048, c
dist.destroy_process_group()
print("ok")
"""


def test_collective_bytes_on_a_one_rank_group():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", COLLECTIVES], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"
