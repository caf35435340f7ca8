"""The port's cost accounting (``repro_torch.launch.hlo_cost.count``).

The programs of ``tests/test_hlo_cost.py`` (a scan of products, a nested
scan, the same unrolled, one product, a loss and its gradient), written
as eager torch loops, count the FLOPs the reference's ``hlo_cost.analyze``
reads off their JAX counterparts' compiled HLO, on the CPU and on meta
tensors. Then the reference's cases as eager loops, the byte rules op by
op, the memory fields, meta = CPU counts (including in-place ops that
change their tensor's layout) and the collectives of ``models.sharding``
under a fake world of 4 (a subprocess of its own: the test process starts
no process group)."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import hlo_cost as ref_hc
from repro_torch.launch import hlo_cost as hc

ROOT = Path(__file__).resolve().parents[1]


def _body(x, w):
    return jnp.tanh(x @ w), None


def _scanned(x, ws):
    return jax.lax.scan(_body, x, ws)[0]


def _nested(x, ws):
    def outer(x, wpair):
        return jax.lax.scan(_body, x, wpair)[0], None
    return jax.lax.scan(outer, x, ws.reshape(4, 2, 128, 128))[0]


def _unrolled(x, ws):
    for i in range(8):
        x, _ = _body(x, ws[i])
    return x


def _loss(w, x):
    return jnp.sum(jnp.tanh(x @ w) ** 2)


def _t_loop(x, ws):
    for i in range(8):
        x = torch.tanh(x @ ws[i])
    return x


def _t_nested(x, ws):
    for pair in ws.reshape(4, 2, 128, 128):
        for w in pair:
            x = torch.tanh(x @ w)
    return x


def _t_loss(w, x):
    return (torch.tanh(x @ w) ** 2).sum()


def _t_grad(w, x):
    with torch.enable_grad():
        w = w.detach().requires_grad_()
        return torch.autograd.grad(_t_loss(w, x), w)[0]


_X, _WS, _A, _XS = (128, 128), (8, 128, 128), (256, 256), (64, 128)
#: name: (the JAX program, its torch counterpart, argument shapes)
PROGRAMS = {
    "scan": (_scanned, _t_loop, (_X, _WS)),
    "nested_scan": (_nested, _t_nested, (_X, _WS)),
    "unrolled": (_unrolled, _t_loop, (_X, _WS)),
    "dot": (lambda a, b: a @ b, lambda a, b: a @ b, (_A, _A)),
    "loss": (_loss, _t_loss, (_X, _XS)),
    "grad": (jax.grad(_loss), _t_grad, (_X, _XS)),
}


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_count_equals_the_reference_analyzer_on_its_programs(name, device):
    jfn, tfn, shapes = PROGRAMS[name]
    text = jax.jit(jfn).lower(*(jax.ShapeDtypeStruct(s, jnp.float32)
                                for s in shapes)).compile().as_text()
    ref = ref_hc.analyze(text)
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                             ).to(device) for s in shapes]
    _, port, _ = hc.count(tfn, *args)
    assert port.flops == ref.flops
    if name in ("scan", "nested_scan", "unrolled"):
        assert port.flops == 8 * 2 * 128 ** 3
    if name == "dot":
        assert port.bytes_accessed == ref.bytes_accessed == 3 * 256 * 256 * 4


# --- count on torch programs --------------------------------------------

def _layer(x, w):
    return torch.tanh(x @ w)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loop_of_products_counts_every_iteration(device):
    x = torch.zeros(128, 128, device=device)
    ws = torch.zeros(8, 128, 128, device=device)

    def loop(x, ws):
        for i in range(8):
            x = _layer(x, ws[i])
        return x
    _, s, _ = hc.count(loop, x, ws)
    assert s.flops == 8 * 2 * 128 ** 3


def test_nested_loops_compose():
    x, ws = torch.zeros(128, 128), torch.zeros(8, 128, 128)

    def nested(x, ws):
        for pair in ws.reshape(4, 2, 128, 128):
            for w in pair:
                x = _layer(x, w)
        return x

    def flat(x, ws):
        for i in range(8):
            x = _layer(x, ws[i])
        return x
    a, b = hc.count(nested, x, ws)[1], hc.count(flat, x, ws)[1]
    assert a.flops == b.flops == 8 * 2 * 128 ** 3


def test_grad_flops_exceed_forward():
    w = torch.randn(128, 128, requires_grad=True)
    x = torch.randn(64, 128)

    def loss(w, x):
        return (torch.tanh(x @ w) ** 2).sum()

    def grad(w, x):
        return torch.autograd.grad(loss(w, x), w)[0]
    ff = hc.count(loss, w, x)[1].flops
    fg = hc.count(grad, w, x)[1].flops
    assert ff == 2 * 64 * 128 * 128
    assert fg >= 2 * ff


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_bytes_include_product_operands(device):
    a = torch.zeros(256, 256, device=device)
    _, s, _ = hc.count(lambda a, b: a @ b, a, a)
    assert s.bytes_accessed == 3 * 256 * 256 * 4


def test_elementwise_chain_adds_no_bytes():
    x = torch.randn(512, 512)
    _, s, _ = hc.count(lambda x: torch.tanh(x * 2 + 1).exp() - x, x)
    assert (s.flops, s.bytes_accessed) == (0.0, 0.0)


@pytest.mark.parametrize("how", ["index", "index_select", "embedding"])
def test_row_gather_counts_the_rows_not_the_table(how):
    table = torch.zeros(100_000, 64, device="meta")
    ids = torch.zeros(10, dtype=torch.long, device="meta")
    fn = {"index": lambda t, i: t[i],
          "index_select": lambda t, i: t.index_select(0, i),
          "embedding": lambda t, i: torch.nn.functional.embedding(
              i, t)}[how]
    _, s, _ = hc.count(fn, table, ids)
    assert s.bytes_accessed == 2 * 10 * 64 * 4


def test_in_place_slice_write_counts_the_slice():
    buf, upd = torch.zeros(1000, 64), torch.ones(4, 64)

    def write(buf, upd):
        buf[5:9] = upd
        return buf
    out, s, mem = hc.count(write, buf, upd)
    assert s.bytes_accessed == 2 * 4 * 64 * 4
    assert mem.alias_bytes == 1000 * 64 * 4 == mem.output_bytes


def test_scatter_counts_the_update():
    buf = torch.zeros(1000, 64)
    idx = torch.tensor([3, 7, 9])
    upd = torch.ones(3, 64)
    _, s, _ = hc.count(lambda b, i, u: b.index_add(0, i, u), buf, idx, upd)
    assert s.bytes_accessed == 2 * 3 * 64 * 4


def test_layout_changes_count_and_contiguous_clones_do_not():
    x = torch.zeros(64, 32)
    _, s, _ = hc.count(lambda x: x.t().contiguous(), x)
    assert s.bytes_accessed == 2 * 64 * 32 * 4
    _, s, _ = hc.count(lambda x: x.clone(), x)
    assert s.bytes_accessed == 0
    _, s, _ = hc.count(lambda x: x.to(torch.bfloat16), x)
    assert s.bytes_accessed == 64 * 32 * (4 + 2)


def test_memory_fields():
    """Arguments, outputs and the peak of the call's own storages with
    the outputs left out: three 64 KiB tensors live at once in each
    iteration (the running x, the product, the next x)."""
    x, ws = torch.zeros(128, 128), torch.zeros(8, 128, 128)

    def loop(x, ws):
        for i in range(8):
            x = _layer(x, ws[i])
        return x
    _, _, mem = hc.count(loop, x, ws)
    tile = 128 * 128 * 4
    assert mem.argument_bytes == 9 * tile
    assert mem.output_bytes == tile
    assert mem.temp_bytes == 3 * tile
    assert mem.alias_bytes == 0
    assert mem.peak_estimate == 9 * tile + tile + 3 * tile


def test_temp_peak_ignores_freed_storages():
    x = torch.zeros(1024)

    def churn(x):
        for _ in range(50):
            y = x * 2          # 4 KiB made and freed each time
            del y
        return x + 1
    _, _, mem = hc.count(churn, x)
    assert mem.temp_bytes == 4096
    assert mem.output_bytes == 4096


def _repeating(x, w, buf):
    """The same shapes again and again: products, reshapes (an alias with
    no annotation: ``_unsafe_view``), layout changes, in-place writes."""
    for i in range(6):
        h = (x @ w).reshape(4, 16, 32).transpose(1, 2).contiguous()
        buf[i % 3].add_(h.sum(0))
        x = torch.tanh(h.reshape(64, 32)[:, :32] @ w.t()).reshape(64, 32)
        buf[(i + 1) % 3, :2] = x[:2, :16]
    return x, buf


def _flattened(a):
    """A reshape of a transposed view: a copy, then ``_unsafe_view`` of it,
    which shares the copy's storage; the previous result stays live."""
    y = a
    for _ in range(4):
        y = a.t().reshape(-1)
    return y.sum()


def _promoting(t):
    """2 and 2.0 are equal keys but promote an integer tensor apart."""
    return t * 2, (t * 2.0).sum()


@pytest.mark.parametrize("program, shapes", [
    (_repeating, ((64, 32), (32, 32), (3, 32, 16))),
    (_flattened, ((256, 64),)), (_promoting, ((128, 8),))],
    ids=["repeating", "flattened", "promoting"])
def test_meta_counts_equal_the_cpu_counts(program, shapes):
    """On meta tensors the mode runs an op seen before with the same
    layouts only once; the counts and the memory fields must equal those
    of the same program on the CPU, where every op runs."""
    args = [torch.randn(s) if program is not _promoting
            else torch.ones(s, dtype=torch.int64) for s in shapes]
    _, s_cpu, m_cpu = hc.count(program, *args)
    _, s_meta, m_meta = hc.count(program, *(a.to("meta") for a in args))
    assert s_meta == s_cpu
    assert m_meta == m_cpu
    if program is _repeating:
        assert s_cpu.flops == 6 * 2 * (2 * 64 * 32 * 32)
        assert m_cpu.alias_bytes == 3 * 32 * 16 * 4
    elif program is _flattened:
        assert m_cpu.temp_bytes == 2 * 256 * 64 * 4


#: in-place ops that change their tensor's layout, each on a fresh tensor
#: of one layout again and again
RELAYOUTS = {
    "unsqueeze_": lambda y: y.unsqueeze_(0),
    "squeeze_": lambda y: y[:, :1].squeeze_(1),
    "transpose_": lambda y: y.transpose_(0, 1),
    "t_": lambda y: y.t_(),
    "as_strided_": lambda y: y.as_strided_((8, 16), (1, 8)),
}


@pytest.mark.parametrize("op", sorted(RELAYOUTS))
def test_meta_in_place_relayouts_run_every_time(op):
    """An in-place op that changes its tensor's shape or strides must not
    be answered from an earlier call with the same input layout."""
    def program(x, w):
        outs = []
        for _ in range(3):
            y = RELAYOUTS[op](x * 2)
            outs.append(y)
            x = x + y.contiguous().reshape(x.shape[0], -1)[:, :1] @ w
        return outs, x
    x, w = torch.randn(16, 8), torch.randn(1, 8)
    (outs, x_cpu), s_cpu, m_cpu = hc.count(program, x, w)
    (outs_m, x_meta), s_meta, m_meta = hc.count(program, x.to("meta"),
                                                w.to("meta"))
    assert [(o.shape, o.stride()) for o in outs_m] == \
        [(o.shape, o.stride()) for o in outs]
    assert x_meta.shape == x_cpu.shape
    assert (s_meta, m_meta) == (s_cpu, m_cpu)


COLLECTIVES = """
import json
import torch
from repro_torch.launch import hlo_cost as hc
from repro_torch.launch.dryrun import fake_world
from repro_torch.models import sharding as sh

with fake_world(4):
    mesh = sh.Mesh((("data", 2), ("model", 2)), device="meta")
    t = torch.zeros(8, 16, device="meta")

    def body(t):
        a = sh.all_gather_raw(mesh, t, "model", 0)
        b = sh.all_reduce_raw(mesh, t, ("data", "model"))
        c = sh.reduce_scatter_raw(mesh, t, "data", 0)
        d = sh.all_to_all_raw(mesh, t, ("data", "model"))
        e = sh.all_reduce_raw(mesh, t, "model")
        return a, b, c, d, e
    _, s, _ = hc.count(body, t, mesh=mesh)
print(json.dumps([s.collective_wire_bytes, s.collective_calls]))
"""


def test_collectives_by_kind_with_ring_factors():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", COLLECTIVES], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    import json
    wire, calls = json.loads(out.stdout.strip().splitlines()[-1])
    t = 8 * 16 * 4
    assert calls == {"all-gather": 1, "all-reduce": 2, "reduce-scatter": 1,
                     "all-to-all": 1}
    # all-gather: the gathered result x (g - 1) / g; all-reduce 2 t (n-1)/n;
    # reduce-scatter: the input x (n - 1) / n; all-to-all: t (n - 1) / n
    assert wire["all-gather"] == 2 * t * 1 / 2
    assert wire["all-reduce"] == 2 * t * 3 / 4 + 2 * t * 1 / 2
    assert wire["reduce-scatter"] == t * 1 / 2
    assert wire["all-to-all"] == t * 3 / 4
