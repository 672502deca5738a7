"""The port's analyzer against the reference's, AST tiers.

* The framework-free families (ST6xx symmetry, ST9xx concurrency, ST907
  kinds, ST11xx ownership) on the reference's own fixtures and on the
  serving host modules the port copies (``serving/{protocol,admission,
  router,slo,supervisor}.py``): the same (line, code, severity) sets.
* ST1xx-ST5xx: each JAX fixture ``bad_{sharding,trace,prng,donation,
  retrace}.py`` has a torch twin here, written defect for defect in
  the port's idiom (a captured step where a jit scope stood, an explicit
  ``torch.Generator`` where a PRNG key stood, a captured step's
  overwritten outputs where a donated buffer stood). The reference on
  its fixture and the port on the twin give the same (line, code,
  severity) sets; the clean twin gives nothing.
* The CLI: the same selector tokens resolve to the same passes (or both
  raise), the same exit codes on the shared fixtures.
* The sharding typo injections of ``tests/analysis/test_injection.py``,
  applied to the port's real modules.

Every reference fixture is read, never edited; the twins are written to
``tmp_path``.
"""

from pathlib import Path

import pytest

import scaletorch_tpu.analysis as janalysis
import scaletorch_tpu_torch.analysis as tanalysis
from scaletorch_tpu.analysis.__main__ import main as jmain
from scaletorch_tpu_torch.analysis.__main__ import main as tmain

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "analysis" / "fixtures"
PORT = REPO / "scaletorch_tpu_torch"
SHARED = ["ST6", "ST9", "ownership"]


def found(findings):
    return sorted((f.line, f.code, f.severity) for f in findings)


def port_findings(paths, select):
    findings, errors = tanalysis.analyze_paths([str(p) for p in paths],
                                               select=select)
    assert not errors
    return findings


def reference_findings(paths, select):
    findings, errors = janalysis.analyze_paths([str(p) for p in paths],
                                               select=select)
    assert not errors
    return findings


@pytest.mark.parametrize("fixture", [
    "bad_concurrency", "bad_async", "bad_kinds", "bad_ownership",
    "bad_symmetry", "clean_concurrency", "clean_ownership",
    "clean_symmetry", "clean"])
def test_shared_families_agree_on_the_reference_fixtures(fixture):
    path = FIXTURES / f"{fixture}.py"
    want = found(reference_findings([path], SHARED))
    assert found(port_findings([path], SHARED)) == want
    if fixture.startswith("bad_"):
        assert want


@pytest.mark.parametrize("module", ["protocol", "admission", "router", "slo",
                                    "supervisor"])
def test_shared_families_agree_on_the_serving_host_copies(module):
    ref = REPO / "scaletorch_tpu" / "serving" / f"{module}.py"
    port = PORT / "serving" / f"{module}.py"
    assert found(port_findings([port], SHARED)) == \
        found(reference_findings([ref], SHARED))


TWINS = {
    "bad_sharding": '''\
"""Torch twin of the sharding fixture. Parsed, never imported."""

import torch
from torch.distributed.device_mesh import init_device_mesh

MESH_AXES = ("dp", "pp", "cp", "ep", "tp")


def make_params():
    return {"q_proj": 1, "k_proj": 2, "layers": {"down_proj": 3}}


def llama_param_specs(tp_axis="tpp"):  # ST101: typo'd default
    return {
        "q_proj": 2,
        "k_proj": ("mdl", 2),     # ST101: 'mdl' is not a mesh axis
        "q_porj": 2,              # ST102: a key no param tree defines
    }


def data_groups(mesh):
    seq_axis = "ctx"                   # ST101: assignment to *_axis
    group = mesh["dp", "epp"]          # ST101: 'epp'
    return init_device_mesh, group, seq_axis


def apply(mesh, x):
    group = mesh.get_group("tensor")   # ST101: 'tensor'
    return torch.distributed.all_reduce(x, group=group)
''',
    "bad_trace": '''\
"""Torch twin of the trace-safety fixture. Parsed, never imported."""

import time

import numpy as np
import torch

from scaletorch_tpu_torch.inference.decode import StaticStep


def make_branchy(inputs, device):
    def branchy_loss(w, x, y):
        loss = torch.mean((w * x - y) ** 2)
        if loss > 1.0:          # ST201: Python branch on a device tensor
            loss = loss * 0.5
        return loss
    return StaticStep(branchy_loss, inputs, device)


def host_sync_step(grads, scale):
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    if scale:               # a host value at every call site: no flag
        norm = norm * scale
    host = float(norm)      # ST202: host sync on a device tensor
    print("norm", host)     # ST204: runs once, at capture
    return norm


def make_step(inputs, device):
    def step(x):
        t0 = time.time()    # ST205: the clock is baked in at capture
        y = np.log(x)       # ST203: host numpy on a device tensor
        while y.sum() > 0:  # ST201: Python while on a device tensor
            y = y - 1
        return y, t0

    return StaticStep(step, inputs, device)


def graph_user(graph, xs):
    def body(carry, x):
        if x > 0:           # ST201: a graph block calls it on tensors
            carry = carry + x
        return carry, carry

    with torch.cuda.graph(graph):
        out = body(torch.zeros(()), xs)
    return out


def capture_sync(graph, grads):
    with torch.cuda.graph(graph):
        host_sync_step(grads, 2.0)
''',
    "bad_prng": '''\
"""Torch twin of the PRNG fixture. Parsed, never imported."""

import time

import torch


def sample_twice(probs, gen):
    a = torch.multinomial(probs, 1, generator=gen)
    b = torch.rand(probs.shape)            # ST301: the global generator
    return a, b


def loop_draws(gen, n):
    outs = []
    for _ in range(n):
        outs.append(torch.randn(4))        # ST301: the global generator
    return outs


def correct_usage(gen, probs):
    a = torch.multinomial(probs, 1, generator=gen)
    b = torch.rand(probs.shape, generator=gen)
    c = torch.empty(2).normal_(generator=gen)
    return a, b, c


def make_clock_seeded(inputs, device):
    from scaletorch_tpu_torch.inference.decode import StaticStep

    def clock_seeded(x):
        gen = torch.Generator().manual_seed(int(time.time()))  # ST302
        return x + torch.randn(x.shape, generator=gen)

    return StaticStep(clock_seeded, inputs, device)
''',
    "bad_donation": '''\
"""Torch twin of the donation fixture. Parsed, never imported."""
import torch

from scaletorch_tpu_torch.inference.decode import StaticStep


def make_decode_step(inputs, device):
    def decode(tokens, cache):
        return tokens * 2, cache + tokens.sum()

    return StaticStep(decode, inputs, device)


def serve(inputs, device, a, b):
    step = make_decode_step(inputs, device)
    out, new_cache = step(tokens=a)
    again = step(tokens=b)
    stale = out.sum()              # ST401: the second call overwrote it
    return again, stale


def serve_correctly(inputs, device, a, b):
    step = make_decode_step(inputs, device)
    out = [t.clone() for t in step(tokens=a)]  # copied: fine
    again = step(tokens=b)
    return out, again


class Engine:
    """The engine's shape: the captured step held on self."""

    def __init__(self, inputs, device):
        self._decode = make_decode_step(inputs, device)

    def decode_twice(self, a, b):
        out, cache = self._decode(tokens=a)
        self._decode(tokens=b)
        occupancy = cache.sum()        # ST401: overwritten by the call
        return occupancy

    def decode_rebound(self, a, b):
        out, cache = self._decode(tokens=a)
        out, cache = self._decode(tokens=b)  # rebound by the call: fine
        return out, cache

    def decode_self_read(self, a, b):
        _, self.cache = self._decode(tokens=a)
        self._decode(tokens=b)
        self.cache = self.cache * 1    # ST401: the rebinding READS it
        return self.cache


update = StaticStep(lambda p, g: (p + g,), {"p": 0, "g": 0}, "cpu")

def train(a, b):
    (new,) = update(p=a, g=b)
    update(p=b, g=a)
    norm = torch.linalg.norm(new)      # ST401: overwritten by the call
    return norm
''',
    "bad_retrace": '''\
"""Torch twin of the retrace fixture. Parsed, never imported."""

import torch

from scaletorch_tpu_torch.inference.decode import StaticStep


def make_step(inputs, device):
    def step(params, batch, lr):
        return params - lr * batch

    return StaticStep(step, inputs, device)


step = make_step({}, torch.device("cpu"))

def train(params, x):
    out = step(params=params, batch={"x": x}, lr=0.01)  # ST501 + ST502
    out2 = step(params=params, batch=[1.0, 2.0], lr=x)   # ST501 list
    return out, out2


def train_ok(params, batch, lr_arr):
    return step(params=params, batch=batch, lr=lr_arr)   # no literals
''',
}

CLEAN_TWIN = '''\
"""Torch twin of the clean fixture: the idioms the passes must NOT
flag. Parsed, never imported."""

import torch

from scaletorch_tpu_torch.inference.decode import StaticStep

MESH_AXES = ("dp", "pp", "cp", "ep", "tp")


def make_params():
    return {"w": torch.ones(4, 4), "b": torch.zeros(4)}


def w_param_specs(tp_axis="tp"):
    return {"w": 1, "b": None}


def groups(mesh):
    return mesh["dp", "cp"], mesh.get_group("tp")


def make_step(inputs, device, training: bool):
    def step(x, mask, gen):
        if x.ndim == 1:                  # shape fact: fine
            x = x[None, :]
        if training:                     # a closure's host flag: fine
            x = x * 2.0
        y = torch.where(mask, x, torch.zeros_like(x))  # the right branch
        return y + torch.rand(y.shape, generator=gen)

    return StaticStep(step, inputs, device)


def serve(inputs, device, a, b, gen):
    step = make_step(inputs, device, training=False)
    out = [t.clone() for t in step(x=a, mask=b, gen=gen)]
    again = step(x=a, mask=b, gen=gen)
    return out, again
'''


@pytest.mark.parametrize("fixture,family", [
    ("bad_sharding", "ST1"), ("bad_trace", "ST2"), ("bad_prng", "ST3"),
    ("bad_donation", "ST4"), ("bad_retrace", "ST5")])
def test_torch_twin_matches_the_reference_fixture(tmp_path, fixture,
                                                  family):
    twin = tmp_path / f"{fixture}.py"
    twin.write_text(TWINS[fixture], encoding="utf-8")
    want = found(reference_findings([FIXTURES / f"{fixture}.py"],
                                    [family]))
    assert want
    assert found(port_findings([twin], [family])) == want


def test_clean_twin_is_clean(tmp_path):
    twin = tmp_path / "clean.py"
    twin.write_text(CLEAN_TWIN, encoding="utf-8")
    assert port_findings([twin], None) == []


@pytest.mark.parametrize("tokens", [
    ["ST9"], ["st901"], ["concurrency"], ["ST1", "prng"], ["ownership"],
    ["ST7"], ["st1001"], ["ST11"], ["ST9q"], ["nope"], [""], ["ST4", "ST5"]])
def test_resolve_select_agrees(tokens):
    try:
        want = janalysis.resolve_select(tokens)
    except ValueError:
        with pytest.raises(ValueError):
            tanalysis.resolve_select(tokens)
        return
    assert tanalysis.resolve_select(tokens) == want


@pytest.mark.parametrize("argv", [
    ["clean.py", "--no-baseline"],
    ["bad_symmetry.py", "--no-baseline"],
    ["bad_ownership.py", "--no-baseline", "--tier", "ownership"],
    ["bad_async.py", "--no-baseline", "--tier", "concurrency"],
    ["clean.py", "--no-baseline", "--tier", "bogus"],
    ["clean.py", "--no-baseline", "--select", "ST7"],
    ["missing_file.py", "--no-baseline"],
    ["clean.py", "--no-baseline", "--hbm-budget", "x.json"],
])
def test_cli_exit_codes_agree(capsys, argv):
    argv = [str(FIXTURES / argv[0])] + argv[1:]
    assert tmain(argv) == jmain(argv)
    capsys.readouterr()


def test_cli_output_format(capsys):
    rc = tmain([str(FIXTURES / "bad_symmetry.py"), "--no-baseline"])
    out, err = capsys.readouterr()
    assert rc == 1
    first = out.splitlines()[0]
    path, line, rest = first.split(":", 2)
    assert path.endswith("bad_symmetry.py") and line.isdigit()
    assert rest.split()[:2] == ["ST601", "error"]
    assert err.strip().endswith("error(s), 2 warning(s)") or \
        "error(s)" in err


def test_port_is_clean_against_its_baseline(capsys):
    """The AST and ownership tiers over the whole port exit 0 against the
    port's baseline, whose every entry says why it is accepted."""
    import json

    baseline = json.loads((PORT / "analysis_baseline.json").read_text())
    assert all(e.get("why") for e in baseline["findings"])
    assert tmain([str(PORT), "--tier", "ast,ownership"]) == 0
    capsys.readouterr()


def _sharding(tmp_path, name, src, companions):
    mutated = tmp_path / name
    mutated.write_text(src, encoding="utf-8")
    return port_findings([mutated] + [PORT / c for c in companions],
                         ["sharding"])


COMPANIONS = ["parallel/mesh.py", "models/llama.py"]


@pytest.mark.parametrize("path,needle,typo,code", [
    ("inference/kv_cache.py",
     'def kv_cache_specs(*, tp_axis: Optional[str] = "tp"',
     'def kv_cache_specs(*, tp_axis: Optional[str] = "tpq"', "ST101"),
    ("inference/kv_cache.py",
     'def paged_kv_cache_specs(*, tp_axis: Optional[str] = "tp")',
     'def paged_kv_cache_specs(*, tp_axis: Optional[str] = "tpp")', "ST101"),
    ("parallel/tensor_parallel.py", '"o_proj": 1,', '"o_porj": 1,',
     "ST102"),
    ("parallel/tensor_parallel.py", '"down_proj": 1,', '"down_porj": 1,',
     "ST102"),
])
def test_injected_sharding_typo_detected(tmp_path, path, needle, typo, code):
    src = (PORT / path).read_text()
    assert needle in src, f"{path} moved; update the test"
    findings = _sharding(tmp_path, Path(path).name,
                         src.replace(needle, typo), COMPANIONS)
    word = typo.split('"')[-2] if code == "ST101" else typo.split('"')[1]
    assert [f.code for f in findings] == [code], [f.render() for f in findings]
    assert f"'{word}'" in findings[0].message


@pytest.mark.parametrize("path", ["inference/kv_cache.py",
                                  "parallel/tensor_parallel.py"])
def test_unmutated_sharding_sources_are_clean(tmp_path, path):
    src = (PORT / path).read_text()
    assert _sharding(tmp_path, Path(path).name, src, COMPANIONS) == []
