"""Guards of the PyTorch port: it imports no JAX and nothing of the JAX
package, its entry points refuse to run without a card unless asked for the
CPU, and its config literals are the JAX package's YAMLs."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml

import quan_ultralytics_tpu_torch
from quan_ultralytics_tpu_torch.cfg.models import MODELS
from quan_ultralytics_tpu_torch.engine.predictor import Predictor
from quan_ultralytics_tpu_torch.engine.trainer import TrainConfig, Trainer
from quan_ultralytics_tpu_torch.models.tasks import DetectionModel

PORT = Path(quan_ultralytics_tpu_torch.__file__).parent
REPO = PORT.parent
# import of jax, flax or the JAX package; the port's own name does not match
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|flax|quan_ultralytics_tpu(?!_torch))\b", re.MULTILINE)
# packages the card's machine does not have: the port reads images, YAML and
# memory sizes without them
ABSENT_ON_CARD = re.compile(
    r"^\s*(?:import|from)\s+(?:cv2|yaml|PIL|matplotlib|psutil|av|imageio|decord|ffmpeg|skvideo)\b",
    re.MULTILINE)


def test_import_loads_no_jax():
    code = ("import quan_ultralytics_tpu_torch, quan_ultralytics_tpu_torch.engine.predictor, "
            "quan_ultralytics_tpu_torch.engine.trainer, quan_ultralytics_tpu_torch.losses.tal, "
            "quan_ultralytics_tpu_torch.losses.detect, quan_ultralytics_tpu_torch.utils.weights, "
            "quan_ultralytics_tpu_torch.engine.validator, quan_ultralytics_tpu_torch.engine.dota_eval, "
            "quan_ultralytics_tpu_torch.data, quan_ultralytics_tpu_torch.data.native.native, "
            "quan_ultralytics_tpu_torch.data.native.pixels, quan_ultralytics_tpu_torch.data.augment, "
            "quan_ultralytics_tpu_torch.cfg.datasets, quan_ultralytics_tpu_torch.utils.metrics, "
            "quan_ultralytics_tpu_torch.utils.callbacks, quan_ultralytics_tpu_torch.utils.checkpoint, "
            "quan_ultralytics_tpu_torch.parallel.prefetch, quan_ultralytics_tpu_torch.utils.settings, "
            "quan_ultralytics_tpu_torch.utils.logging, quan_ultralytics_tpu_torch.utils.integrations, "
            "quan_ultralytics_tpu_torch.cfg, quan_ultralytics_tpu_torch.data.loaders, "
            "quan_ultralytics_tpu_torch.engine.model, quan_ultralytics_tpu_torch.cli, "
            "quan_ultralytics_tpu_torch.classification.cli, quan_ultralytics_tpu_torch.classification.train, "
            "quan_ultralytics_tpu_torch.classification.data, quan_ultralytics_tpu_torch.classification.models, "
            "quan_ultralytics_tpu_torch.cfg.model_yaml, quan_ultralytics_tpu_torch.models.ensemble, "
            "quan_ultralytics_tpu_torch.ops.activations, quan_ultralytics_tpu_torch.trackers, "
            "quan_ultralytics_tpu_torch.trackers.gmc, quan_ultralytics_tpu_torch.engine.tuner, "
            "quan_ultralytics_tpu_torch.engine.exporter, quan_ultralytics_tpu_torch.utils.profiler, "
            "quan_ultralytics_tpu_torch.utils.autobatch, quan_ultralytics_tpu_torch.utils.benchmarks, sys; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'quan_ultralytics_tpu', 'cv2', 'yaml', 'PIL', 'matplotlib', 'psutil')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


ALONE_MODULES = [
    "quan_ultralytics_tpu_torch.cfg.model_yaml",
    "quan_ultralytics_tpu_torch.models.ensemble",
    "quan_ultralytics_tpu_torch.ops.activations",
    "quan_ultralytics_tpu_torch.trackers.kalman",
    "quan_ultralytics_tpu_torch.trackers.matching",
    "quan_ultralytics_tpu_torch.trackers.byte_tracker",
    "quan_ultralytics_tpu_torch.trackers.bot_sort",
    "quan_ultralytics_tpu_torch.trackers.gmc",
    "quan_ultralytics_tpu_torch.engine.tuner",
    "quan_ultralytics_tpu_torch.engine.exporter",
    "quan_ultralytics_tpu_torch.utils.profiler",
    "quan_ultralytics_tpu_torch.utils.autobatch",
    "quan_ultralytics_tpu_torch.utils.benchmarks",
]
PLOT_MODULES = [  # the plots, the text raster, the reference-weights loader, the metrics' charts
    "quan_ultralytics_tpu_torch.utils.plotting",
    "quan_ultralytics_tpu_torch.utils.font",
    "quan_ultralytics_tpu_torch.utils.torch_port",
    "quan_ultralytics_tpu_torch.utils.metrics",
]
SLICE14_MODULES = [  # data parallelism, int8 serving and the last tooling modules
    "quan_ultralytics_tpu_torch.parallel.distributed",
    "quan_ultralytics_tpu_torch.parallel.mesh",
    "quan_ultralytics_tpu_torch.ops.quant",
    "quan_ultralytics_tpu_torch.ops.qgeo",
    "quan_ultralytics_tpu_torch.ops.qinit",
    "quan_ultralytics_tpu_torch.losses.prototypes",
    "quan_ultralytics_tpu_torch.utils.instance",
    "quan_ultralytics_tpu_torch.data.converter",
    "quan_ultralytics_tpu_torch.data.split_dota",
]
STEM_MODULES = ["quan_ultralytics_tpu_torch.ops.stem"]  # the phase-packed stem's expansions
VIDEO_MODULES = [  # the video demuxers and decoders, and the sources that read them
    "quan_ultralytics_tpu_torch.data.native.video",
    "quan_ultralytics_tpu_torch.data.loaders",
]
_ALONE_CODE = ("import {}, sys; bad = sorted(m for m in sys.modules if m.split('.')[0] in "
               "('jax', 'quan_ultralytics_tpu', 'yaml', 'cv2', 'PIL', 'matplotlib', 'psutil')); "
               "assert not bad, bad")


@pytest.fixture(scope="module")
def imported_alone():
    """Each of ALONE_MODULES and PLOT_MODULES imported in a fresh interpreter
    of its own, all started at once: module -> (exit code, standard error)."""
    procs = {m: subprocess.Popen([sys.executable, "-c", _ALONE_CODE.format(m)], cwd=REPO,
                                 stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
             for m in ALONE_MODULES + PLOT_MODULES + SLICE14_MODULES + STEM_MODULES + VIDEO_MODULES}
    out = {}
    for m, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        out[m] = (proc.returncode, err)
    return out


@pytest.mark.parametrize("module", ALONE_MODULES)
def test_new_module_alone_loads_no_jax_yaml_cv2_or_pil(module, imported_alone):
    """The model-YAML reader, the ensemble, the activations, the trackers, the
    tuner, the exporter, the profiler, AutoBatch and the benchmarks, each
    imported alone in a fresh interpreter, load none of jax, the JAX package,
    yaml, cv2, PIL, matplotlib or psutil."""
    rc, err = imported_alone[module]
    assert rc == 0, err


def test_plot_modules_alone_load_no_jax_cv2_pil_or_matplotlib(imported_alone):
    """The plots, the text raster, the reference-weights loader and the
    metrics (their charts), each imported alone in a fresh interpreter, load
    none of jax, the JAX package, yaml, cv2, PIL, matplotlib or psutil (one
    test, so that this file keeps its place in pytest-xdist's queue)."""
    for module in PLOT_MODULES:
        rc, err = imported_alone[module]
        assert rc == 0, f"{module}: {err}"


@pytest.mark.parametrize("module", SLICE14_MODULES)
def test_parallel_int8_and_tool_modules_alone_load_no_jax_cv2_pil_or_matplotlib(module, imported_alone):
    """`parallel.distributed`, `parallel.mesh`, `ops.quant`, `ops.qgeo`,
    `ops.qinit`, `losses.prototypes`, `utils.instance`, `data.converter` and
    `data.split_dota`, each imported alone in a fresh interpreter, load none
    of jax, the JAX package, yaml, cv2, PIL, matplotlib or psutil."""
    rc, err = imported_alone[module]
    assert rc == 0, err


def test_stem_module_alone_loads_no_jax_and_every_jax_module_has_its_counterpart(imported_alone):
    """`ops.stem`, imported alone in a fresh interpreter, loads none of jax, the
    JAX package, yaml, cv2, PIL, matplotlib or psutil; and every module of the
    JAX package's tree outside ``ops/pallas/`` has a module of the same path in
    the port."""
    for module in STEM_MODULES:
        rc, err = imported_alone[module]
        assert rc == 0, f"{module}: {err}"
    jax_pkg = REPO / "quan_ultralytics_tpu"
    missing = [str(p.relative_to(jax_pkg)) for p in sorted(jax_pkg.rglob("*.py"))
               if "pallas" not in p.relative_to(jax_pkg).parts
               and not (PORT / p.relative_to(jax_pkg)).exists()]
    assert not missing, missing


@pytest.mark.parametrize("module", VIDEO_MODULES)
def test_video_modules_alone_load_no_jax_cv2_pil_or_video_library(module, imported_alone):
    """The video demuxers and decoders, and the predict sources that read
    them, each imported alone in a fresh interpreter, load none of jax, the
    JAX package, yaml, cv2, PIL, matplotlib or psutil; the scans below find no
    import of a video library in the port."""
    rc, err = imported_alone[module]
    assert rc == 0, err


# the C++ standard headers the host libraries may include; anything else is a library
STD_HEADERS = {"algorithm", "cmath", "cstdint", "cstdio", "cstdlib", "cstring", "limits", "memory", "string",
               "utility", "vector", "stdint.h", "string.h", "array", "cassert", "climits", "functional"}


def test_native_sources_include_and_link_no_codec_library():
    """The host libraries (the image and video decoders, VP8's core in
    ``vp8.h`` among them) include only C++ standard headers and their own
    files, and are built with no library to link: no libavcodec, libvpx,
    libwebp, libjpeg or other codec library reaches the port."""
    from quan_ultralytics_tpu_torch.data.native import native, pixels, video

    native_dir = PORT / "data" / "native"
    sources = sorted(native_dir.glob("*.cpp")) + sorted(native_dir.glob("*.h"))
    assert {"video.cpp", "vp8.h", "webp.cpp"} <= {p.name for p in sources}
    bad = []
    for path in sources:
        for inc in re.findall(r'^\s*#\s*include\s*([<"][^>"]+[>"])', path.read_text(), re.M):
            name = inc[1:-1]
            ok = name in STD_HEADERS if inc[0] == "<" else (native_dir / name).is_file()
            if not ok:
                bad.append(f"{path.name}: #include {inc}")
    assert not bad, bad
    for flags in (native.CXX_FLAGS, pixels.CXX_FLAGS, video.CXX_FLAGS):
        assert not [f for f in flags if f.startswith(("-l", "-L", "-Wl"))], flags
    assert set(video.DEPENDS) >= {native_dir / "vp8.h", native_dir / "webp_tables.h"}


def test_source_scan_finds_no_jax_import():
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
           for p in files for m in FORBIDDEN.finditer(p.read_text())]
    assert not bad, bad
    assert FORBIDDEN.search("from quan_ultralytics_tpu.ops import mixing")
    assert not FORBIDDEN.search("from quan_ultralytics_tpu_torch.ops import mixing")


def test_source_scan_finds_no_package_the_card_lacks():
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
           for p in files for m in ABSENT_ON_CARD.finditer(p.read_text())]
    assert not bad, bad
    for line in ("import cv2", "    import yaml", "from PIL import Image", "import matplotlib.pyplot",
                 "import psutil", "import av", "from imageio import v3"):
        assert ABSENT_ON_CARD.search(line), line
    assert not ABSENT_ON_CARD.search("import yamlish")


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=15)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=15, device="cuda")
    model = DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=15, device="cpu")
    assert Predictor(model).device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model, TrainConfig(), steps_per_epoch=1)
    assert Trainer(model, TrainConfig(), steps_per_epoch=1, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("name", sorted(MODELS))
def test_config_literal_equals_yaml(name):
    with open(REPO / "quan_ultralytics_tpu" / "cfg" / "models" / name) as fh:
        assert MODELS[name] == yaml.safe_load(fh), name


def test_a_process_group_that_cannot_form_raises(monkeypatch):
    """`initialize` and `make_mesh` raise, and never fall back to one process,
    when asked for a backend or a device that cannot serve the group."""
    import datetime

    import torch.distributed as dist

    from quan_ultralytics_tpu_torch.parallel import distributed
    from quan_ultralytics_tpu_torch.parallel.mesh import make_mesh

    kw = dict(world_size=1, rank=0, timeout=datetime.timedelta(seconds=10))
    if not dist.is_nccl_available():  # a torch without nccl refuses it
        with pytest.raises(RuntimeError, match="nccl"):
            distributed.initialize(backend="nccl", init_method=f"tcp://localhost:{distributed.free_port()}", **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="nccl|CUDA"):  # nccl without a card
        distributed.initialize(device="cuda", init_method=f"tcp://localhost:{distributed.free_port()}", **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group of 2"):  # two ranks wanted, none formed
        make_mesh(2, device="cpu")
    assert distributed.initialize() is False  # no torchrun environment: one process
