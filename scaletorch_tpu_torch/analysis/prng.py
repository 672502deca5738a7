"""ST3xx — random-number hygiene.

The port draws every random number from an explicit
``torch.Generator`` seeded by its caller (the counterpart of the
reference's explicit PRNG keys): a draw from PyTorch's global
generator depends on every other draw the process made before it, so a
run cannot be replayed and two ranks, or a test and the card, stop
agreeing without any error. The pass flags:

ST301  a sampling call (``torch.rand*``/``randn*``/``randint*``/
       ``randperm``/``multinomial``/``bernoulli``/``normal``/
       ``poisson``, the in-place ``normal_``/``uniform_``/...,
       ``dropout``) with no ``generator=``: it reads the global
       generator (dropout has no ``generator`` argument at all, so a
       dropout on the main path always does)
ST302  a generator seeded from wall-clock or OS entropy (``time.*``,
       ``os.urandom``, ``random.*``, ``np.random``, an argument-less
       ``.seed()``) inside a captured scope: the seed is fixed at
       capture, every replay reuses it
"""

from __future__ import annotations

import ast
from typing import List

from .core import Finding
from .scopes import ModuleScopes, ProjectIndex, dotted_name, tail_name

# torch.<name>(...) / torch.nn.functional.<name>(...) draws
_SAMPLER_FUNCTIONS = {
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "multinomial", "bernoulli", "normal", "poisson",
    "dropout", "dropout1d", "dropout2d", "dropout3d", "alpha_dropout",
    "feature_alpha_dropout", "gumbel_softmax", "rrelu",
}
# <tensor>.<name>(...) draws (and torch.nn.init.<name>(...))
_SAMPLER_METHODS = {
    "normal_", "uniform_", "bernoulli_", "exponential_", "geometric_",
    "log_normal_", "cauchy_", "random_", "multinomial", "bernoulli",
    "trunc_normal_", "xavier_uniform_", "xavier_normal_",
    "kaiming_uniform_", "kaiming_normal_", "orthogonal_",
}
_TORCH_RECEIVERS = ("torch", "torch.nn.functional", "F", "nn.functional")
_SEEDERS = {"manual_seed", "seed"}
_ENTROPY_SOURCES = ("time.", "os.urandom", "random.", "np.random",
                    "numpy.random", "secrets.", "uuid.")


def run(index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    for ms in index.scopes.values():
        findings.extend(_check_module(ms))
    return findings


def _sampler_name(node: ast.Call) -> str:
    """'randn' for ``torch.randn(...)``, 'normal_' for ``w.normal_()``,
    '' for anything else."""
    if not isinstance(node.func, ast.Attribute):
        return ""
    d = dotted_name(node.func) or ""
    recv = dotted_name(node.func.value) or ""
    attr = node.func.attr
    if recv in _TORCH_RECEIVERS and attr in _SAMPLER_FUNCTIONS:
        return attr
    # numpy's and JAX's ``random`` modules take their state explicitly
    # (a Generator, a key): not the global torch generator
    if attr in _SAMPLER_METHODS and \
            recv.rsplit(".", 1)[-1] not in ("np", "numpy", "random") \
            and not recv.startswith(("np.", "numpy.", "jax.")):
        return attr
    if d.startswith("torch.nn.init.") and attr in _SAMPLER_METHODS:
        return attr
    return ""


def _check_module(ms: ModuleScopes) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(ms.sm.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _sampler_name(node)
        if not name or any(kw.arg == "generator" for kw in node.keywords):
            continue
        out.append(Finding(
            file=ms.sm.rel, line=node.lineno, code="ST301", severity="error",
            message=(
                f"`{dotted_name(node.func)}()` draws from the global "
                "generator (no generator=) — the draw depends on every "
                "earlier draw in the process; pass an explicit, seeded "
                "torch.Generator"
            ),
        ))
    for fn, _ in ms.traced_functions():
        if isinstance(fn, ast.Lambda):
            continue
        out.extend(_check_entropy_seeds(ms, fn))
    return out


def _entropy_source(arg: ast.AST) -> str:
    for inner in ast.walk(arg):
        if not isinstance(inner, ast.Call):
            continue
        d = dotted_name(inner.func) or ""
        if any(d.startswith(src) or d == src.rstrip(".")
               for src in _ENTROPY_SOURCES):
            return d
    return ""


def _check_entropy_seeds(ms: ModuleScopes, fn: ast.AST) -> List[Finding]:
    out: List[Finding] = []
    for node in _own_body_nodes(fn):
        if not isinstance(node, ast.Call):
            continue
        name = (node.func.attr if isinstance(node.func, ast.Attribute)
                else tail_name(node.func))
        if name not in _SEEDERS:
            continue
        if name == "seed" and not node.args:
            source = "OS entropy (.seed())"
        else:
            source = next((s for s in map(_entropy_source, node.args) if s),
                          "")
            if source:
                source = f"`{source}`"
        if not source:
            continue
        out.append(Finding(
            file=ms.sm.rel, line=node.lineno, code="ST302",
            severity="error",
            message=(
                f"generator seeded from {source} inside a captured scope "
                "— the seed is fixed at capture, every replay reuses it"
            ),
        ))
    return out


def _own_body_nodes(fn: ast.AST):
    """Nodes of ``fn``'s body, nested defs excluded (they are captured
    scopes of their own)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))
