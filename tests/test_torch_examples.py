"""The port's examples (``examples/port_*.py``) beside the reference's, on the
CPU at the reference's sizes.

Each reference example runs in this process as its script would (its
``main()`` where it has one, else its module body), and its port runs
through ``main(["--device", "cpu", ...])``; both print to captured
standard output.  Every line must be equal -- the byte outputs (reads
correct, restores bit-identical, the compact stripe table, generated
tokens) and the virtual-time figures alike -- except where a line names a
file the example wrote, which is held by content instead: the trace and the
metrics series the port writes must equal the reference's.  ``port_serve``
and ``port_train_e2e`` start from the reference's own initial parameters
(``models/convert.py``): the generated tokens must be equal, and the
training losses agree within ``tests/test_torch_train.py``'s tolerance
(the run's steps are the reference example's own 20).
"""
import ast
import contextlib
import importlib.util
import io
import json
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from _port import model_pair
from repro.launch import train as jtrain

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
# written files: (the reference's name, the port's)
OUTPUTS = {"trace_and_metrics": (("trace.json", "port_trace.json"),
                                 ("metrics.json", "port_metrics.json")),
           "scrub_repair": (("scrub_metrics.json", "port_scrub_metrics.json"),)}
GENERIC = ("quickstart", "trace_replay", "degraded_restore", "ckpt_under_serving",
           "warm_cache_degraded", "trace_and_metrics", "degraded_writes", "scrub_repair")


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(f"example_{path.stem}", path)
    return spec, importlib.util.module_from_spec(spec)


def _reference(name: str, out: Path, monkeypatch) -> str:
    """The standard output of ``examples/<name>.py`` run as a script, its
    files written under ``out``."""
    path = EXAMPLES / f"{name}.py"
    monkeypatch.setattr(sys, "argv", [str(path)])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        spec, mod = _module(path)
        spec.loader.exec_module(mod)  # a script without main() runs here
        if hasattr(mod, "main"):
            mod.OUT = str(out)
            mod.main()
    return buf.getvalue()


def _port(name: str, argv=(), **kw) -> tuple[str, dict]:
    """(standard output, returned dict) of ``examples/port_<name>.py``'s
    ``main`` on the CPU."""
    spec, mod = _module(EXAMPLES / f"port_{name}.py")
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = mod.main(["--device", "cpu", *argv], **kw)
    return buf.getvalue(), got


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("name", GENERIC)
def test_port_example_prints_the_reference_lines(name, tmp_path, monkeypatch):
    files = OUTPUTS.get(name, ())
    want = _reference(name, tmp_path / "ref", monkeypatch)
    got, res = _port(name, ["--out", str(tmp_path / "port")] if files else [])
    assert isinstance(res, dict) and res
    for ref_name, port_name in files:
        want = want.replace(str(tmp_path / "ref" / ref_name), "<file>")
        got = got.replace(str(tmp_path / "port" / port_name), "<file>")
        assert json.loads((tmp_path / "port" / port_name).read_text()) == \
            json.loads((tmp_path / "ref" / ref_name).read_text()), ref_name
    assert got.splitlines() == want.splitlines()


def test_port_serve_generates_the_reference_tokens(monkeypatch):
    """From the reference's init of smoke qwen2.5-3b, the same 4 x 16
    greedy tokens."""
    _, _, jparams, _ = model_pair("qwen2.5-3b")
    want = _reference("serve", Path("unused"), monkeypatch)
    got, res = _port("serve", init_params=_np(jparams))
    assert got.splitlines() == want.splitlines()
    assert np.array(res["tokens"]).shape == (4, 16)


def test_port_train_e2e_trains_as_the_reference(monkeypatch):
    """From the reference's init of smoke smollm-135m, the example's 20
    steps with a lane failed at step 8 and a restart at step 14: the losses
    within 1e-5 (the repeated steps included), the same step lines, the
    same checkpoint engine counters."""
    runs = []
    real = jtrain.run
    monkeypatch.setattr(jtrain, "run", lambda argv: runs.append(real(argv)) or runs[-1])
    want = _reference("train_e2e", Path("unused"), monkeypatch)
    _, _, jparams, _ = model_pair("smollm-135m")
    got, res = _port("train_e2e", init_params=_np(jparams))
    (losses,) = runs
    assert len(res["losses"]) == len(losses) == 24  # steps 11-14 are taken twice
    np.testing.assert_allclose(res["losses"], losses, rtol=1e-5, atol=1e-6)
    assert res["losses"][14:18] == res["losses"][10:14]

    def lines(text):  # the step lines with their losses cut out, and the counters
        steps = [re.sub(r"loss=[-\d.]+", "loss", s) for s in text.splitlines()
                 if not s.startswith("done:")]
        (done,) = [s for s in text.splitlines() if s.startswith("done:")]
        return steps, ast.literal_eval(done.split("ckpt stats: ")[1])

    assert lines(got) == lines(want)
    assert res["engine"] == lines(want)[1]
