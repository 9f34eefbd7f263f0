"""The port's exporter (``engine/exporter.py``) and the facade's ``export`` and
``YOLO("m.pt2")`` against the live model and the JAX package.

QUAN-YOLO11n-OBB (nc 3) at imgsz 64 with seeded weights (``fill_variables``,
written by the JAX facade's ``export_params``), on 64 x 64 frames.

* ``format=exported`` on the CPU: the ``.pt2`` reloads and its forward +
  decode equals the live model's within 1e-5 (the same ATen operators in
  the same order: measured 0); in a fresh interpreter that imports torch
  alone it gives the same output; ``YOLO("m.pt2").predict`` keeps the live
  facade's boxes (the artifact's batch 2 taking 3 frames: two pieces, the
  last padded).
* On the card the graph calls the kernels as registered operators: traced
  on the meta device (shapes only, through the operators' fake
  implementations), the graph holds 1 ``quan_torch::qattention_fwd`` and 37
  ``quan_torch::qconv1x1_fused`` nodes and no other operator of the port.
* ``format=params`` both ways: the port's payload of a JAX ``export_params``
  file is that file's, array for array, and the JAX facade predicts from the
  port's file what the port predicts from JAX's (decode tolerance 1e-4
  max|ref| + 1e-5). One JAX Predictor compiles.
* The JAX package's other formats raise, with the reason, and so do its
  tflite options ``half`` and ``int8`` (through the facade and the CLI), which
  no format here reads.
"""

import copy
import pickle
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quan_ultralytics_tpu.engine.model import YOLO as JaxYOLO
from quan_ultralytics_tpu_torch import cli
from quan_ultralytics_tpu_torch.engine import exporter
from quan_ultralytics_tpu_torch.engine.model import YOLO
from quan_ultralytics_tpu_torch.utils.weights import read_checkpoint
from torch_port_helpers import jax_variables, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

CFG, NC, IMGSZ, NAMES = "yolo11n-obb-quan.yaml", 3, 64, ["plane", "ship", "storage-tank"]


def _tol(ref):
    return 1e-4 * (float(np.abs(ref).max()) if ref.size else 0.0) + 1e-5


def _frames(n=3):
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, (IMGSZ, IMGSZ, 3), dtype=np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """A JAX ``export_params`` file of seeded weights, the port's facade on it,
    the port's ``exported`` artifact of it (batch 2) and the facade on that."""
    tmp = tmp_path_factory.mktemp("export")
    jy = JaxYOLO(CFG, nc=NC)
    jy.variables = jax_variables(jy.model.module, jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False, seed=9)
    jy.names = NAMES
    jax_pkl = jy.export(format="params", path=str(tmp / "jax.pkl"))
    port = YOLO(jax_pkl, device="cpu")
    pt2 = port.export(format="exported", imgsz=IMGSZ, batch=2, path=str(tmp / "m.pt2"))
    return {"tmp": tmp, "jax_pkl": jax_pkl, "port": port, "pt2": pt2, "art": YOLO(pt2, device="cpu")}


def test_exported_artifact_matches_the_live_model(made):
    port = made["port"]
    x = torch.rand(2, IMGSZ, IMGSZ, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = port.model.decode(port.model(x))
    backend = made["art"].model
    assert isinstance(backend, exporter.ExportedBackend)
    got = backend(x)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    assert (backend.task, backend.nc, backend.names, backend.imgsz, backend.batch) == ("obb", NC, NAMES, IMGSZ, 2)
    assert backend.meta["model_yaml"] == CFG and backend.meta["strides"] == [8, 16, 32]
    torch.testing.assert_close(backend(x[:1]), ref[:1], rtol=0, atol=1e-5)  # padded to 2


def test_exported_artifact_runs_with_torch_alone(made):
    x = torch.rand(2, IMGSZ, IMGSZ, 3, generator=torch.Generator().manual_seed(1))
    inp, out = made["tmp"] / "x.pt", made["tmp"] / "y.pt"
    torch.save(x, inp)
    code = ("import sys, torch; "
            f"m = torch.export.load({made['pt2']!r}).module(); "
            f"torch.save(m(torch.load({str(inp)!r})), {str(out)!r}); "
            "bad = [k for k in sys.modules if k.startswith(('quan_ultralytics', 'jax'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300, cwd=made["tmp"])
    port = made["port"]
    with torch.no_grad():
        ref = port.model.decode(port.model(x))
    torch.testing.assert_close(torch.load(out), ref, rtol=0, atol=1e-5)


def test_yolo_predicts_from_the_artifact_as_the_live_facade(made):
    frames = _frames(3)
    got = made["art"]
    assert got.task == "obb" and got.names == NAMES and got.model_yaml == CFG
    res = got.predict(frames, imgsz=640, conf=0.001)  # the artifact's own 64 is used
    ref = made["port"].predict(frames, imgsz=IMGSZ, conf=0.001)
    assert len(res) == len(ref) == 3 and sum(len(r) for r in ref) > 0
    for g, r in zip(res, ref):
        assert len(g) == len(r)
        np.testing.assert_array_equal(g.cls, r.cls)
        np.testing.assert_allclose(g.boxes, r.boxes, rtol=0, atol=_tol(r.boxes))


def test_exported_graph_calls_the_kernels_as_registered_operators(made):
    meta = copy.deepcopy(made["port"].model).to("meta").eval()
    with torch.no_grad():
        program = torch.export.export(exporter._Inference(meta), (torch.empty(2, 1024, 1024, 3, device="meta"),),
                                      strict=False)
    ops = Counter(str(n.target) for n in program.graph.nodes if n.op == "call_function")
    ours = {k: v for k, v in ops.items() if k.startswith(("quan_torch", "quan"))}
    assert ours == {"quan_torch.qattention_fwd.default": 1, "quan_torch.qconv1x1_fused.default": 37}


def test_deep_stem_model_exports(made):
    """A model built with stem_deep=1 exports (the index-map gathers of its
    packed weights are traced like any operator): the .pt2 gives the live
    model's outputs on the CPU, and on the card's graph (traced on the meta
    device) K1 and K3 stay ``quan_torch`` operators, K3 at the 35 sites outside
    the packed region."""
    from quan_ultralytics_tpu_torch.models.tasks import DetectionModel

    live = DetectionModel.from_yaml(CFG, nc=NC, device="cpu", stem_deep=1)
    live.load_state_dict(made["port"].model.state_dict())
    path = exporter.export_compiled(live, imgsz=IMGSZ, batch=2, path=str(made["tmp"] / "deep.pt2"),
                                    model_yaml=CFG)
    x = torch.rand(2, IMGSZ, IMGSZ, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref = live.decode(live(x))
        plain = made["port"].model.decode(made["port"].model(x))
    got = YOLO(path, device="cpu").model(x)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(got, plain, rtol=0, atol=_tol(plain.numpy()))
    meta = copy.deepcopy(live).to("meta").eval()
    with torch.no_grad():
        program = torch.export.export(exporter._Inference(meta), (torch.empty(2, 1024, 1024, 3, device="meta"),),
                                      strict=False)
    ops = Counter(str(n.target) for n in program.graph.nodes if n.op == "call_function")
    ours = {k: v for k, v in ops.items() if k.startswith(("quan_torch", "quan"))}
    assert ours == {"quan_torch.qattention_fwd.default": 1, "quan_torch.qconv1x1_fused.default": 35}


def test_params_export_reads_both_ways(made):
    port_pkl = made["port"].export(format="params", path=str(made["tmp"] / "port.pkl"))
    got, ref = read_checkpoint(port_pkl), pickle.loads(Path(made["jax_pkl"]).read_bytes())
    assert set(got) == set(ref) == {"model_yaml", "nc", "names", "params", "batch_stats"}
    assert (got["model_yaml"], got["nc"], got["names"]) == (ref["model_yaml"], ref["nc"], ref["names"])

    def flat(tree, prefix=()):
        for k, v in tree.items():
            yield from flat(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]

    for col in ("params", "batch_stats"):
        g, r = dict(flat(got[col])), dict(flat(ref[col]))
        assert g.keys() == r.keys()
        assert all(np.array_equal(g[k], np.asarray(r[k])) for k in r)
    frames = _frames(2)
    from_port = JaxYOLO(port_pkl).predict(frames, imgsz=IMGSZ, conf=0.001)
    from_jax = made["port"].predict(frames, imgsz=IMGSZ, conf=0.001)
    assert sum(len(r) for r in from_port) > 0
    for g, r in zip(from_jax, from_port):
        assert len(g) == len(r)
        np.testing.assert_array_equal(g.cls, r.cls)
        np.testing.assert_allclose(g.boxes, r.boxes, rtol=0, atol=_tol(r.boxes))


@pytest.mark.parametrize("fmt,exc,match", [
    ("stablehlo", ValueError, "format='exported' is its counterpart"),
    ("tflite", RuntimeError, "needs TensorFlow"), ("saved_model", RuntimeError, "needs TensorFlow"),
    ("pb", RuntimeError, "needs TensorFlow"), ("onnx", RuntimeError, "tf2onnx"),
    ("torchscript", ValueError, "unknown export format"),
])
def test_other_formats_raise_with_the_reason(made, fmt, exc, match):
    with pytest.raises(exc, match=match):
        made["port"].export(format=fmt, path=str(made["tmp"] / "x"))
    assert not (made["tmp"] / "x").exists()


@pytest.mark.parametrize("opt", ["half", "int8"])
def test_tflite_options_are_refused(made, opt, monkeypatch):
    with pytest.raises(TypeError, match=opt):
        made["port"].export(format="exported", path=str(made["tmp"] / "h.pt2"), **{opt: True})
    monkeypatch.chdir(made["tmp"])
    with pytest.raises(SystemExit, match=opt) as e:
        cli.main(["obb", "export", f"model={made['jax_pkl']}", "format=params", "path=h.pkl", f"{opt}=True",
                  "device=cpu"])
    assert e.value.code not in (0, None)
    assert not (made["tmp"] / "h.pt2").exists() and not (made["tmp"] / "h.pkl").exists()
