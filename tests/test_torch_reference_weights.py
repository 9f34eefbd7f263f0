"""Reference-layout checkpoints (``utils/torch_port.py``) against the JAX
package's ``utils/torch_port.py``, on the CPU.

No reference weights are in the repository: each test draws a state dict in
the reference's names and layouts with numpy. Its names come from the JAX
package's own ``torch_prefix`` / ``_cls_prefix`` over the JAX model's
variable tree (shapes from ``jax.eval_shape``), its arrays are the seeded
flax leaves in the inverse layouts (per-component OIHW QConv2D weights,
``[C, 4]`` IQBN statistics, the QER kernel in the reference's c-major
quaternion order), put there by the port's ``to_reference_state_dict``.
Held:

* every leaf of the port model after `port_state_dict` (read back with
  ``export_jax_variables``) equals the leaf that JAX's ``port_state_dict``
  gives for the same dict, and the drawn leaf, for the four detection task
  graphs; ``to_reference_state_dict`` of the ported model gives the dict
  back, name for name and bit for bit;
* a ported OBB model's outputs equal, bit for bit, those of the same leaves
  carried by ``load_jax_variables``; torch tensors are taken as well as
  numpy arrays.

The ported model's forward against the JAX model on JAX's port of the same
dict is in ``test_torch_model.py``; the classification families are in
``test_torch_reference_cls_weights.py``.
Each file holds few tests (cases loop inside them): pytest-xdist's ``--dist
loadfile`` queues files by their number of tests, and these then come after
every long JAX test file, so they run beside them and do not delay them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quan_ultralytics_tpu.models.tasks import DetectionModel as JaxDetectionModel
from quan_ultralytics_tpu.utils import torch_port as jport
from quan_ultralytics_tpu_torch.models.tasks import DetectionModel
from quan_ultralytics_tpu_torch.utils import torch_port as tport
from quan_ultralytics_tpu_torch.utils.weights import export_jax_variables, load_jax_variables
from torch_port_helpers import fill_variables, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _assert_same_leaves(port_model, jax_tree):
    got = {p: a for coll in export_jax_variables(port_model).values() for p, a in _leaves(coll)}
    ref = {p: a for coll in jax_tree.values() for p, a in _leaves(coll)}
    assert got.keys() == ref.keys()
    for p in ref:
        np.testing.assert_array_equal(got[p], np.asarray(ref[p], np.float32), err_msg="/".join(p))


def _detect_case(cfg, nc, seed):
    jm = JaxDetectionModel.from_yaml(cfg, nc=nc)
    shapes = jax.eval_shape(lambda: jm.module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                                   train=False))
    v = jax.tree_util.tree_map(np.asarray, fill_variables(shapes, seed))
    return v, tport.to_reference_state_dict(v, jport.torch_prefix)


def test_detection_state_dict_ports_as_jax_does():
    for cfg, nc in (("yolo11n-obb-quan.yaml", 15), ("yolo11n-quan.yaml", 80), ("yolo11n-seg-quan.yaml", 80),
                    ("yolo11n-pose-quan.yaml", 1)):
        v, sd = _detect_case(cfg, nc, seed=3)
        ref = jport.port_state_dict(sd, v)
        tm = DetectionModel.from_yaml(cfg, nc=nc, device="cpu")
        assert tport.port_state_dict(sd, tm) is tm
        _assert_same_leaves(tm, ref)
        # to_reference_state_dict is the inverse of both packages' port_state_dict
        _assert_same_leaves(tm, v)
        back = tport.to_reference_state_dict(export_jax_variables(tm))
        assert back.keys() == sd.keys()
        for k in sd:
            np.testing.assert_array_equal(back[k], sd[k], err_msg=k)


def test_ported_obb_model_runs_as_the_carried_one():
    v, sd = _detect_case("yolo11n-obb-quan.yaml", 15, seed=4)
    ported = tport.port_state_dict({k: to_torch(a) for k, a in sd.items()},
                                   DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=15, device="cpu")).eval()
    carried = load_jax_variables(DetectionModel.from_yaml("yolo11n-obb-quan.yaml", nc=15, device="cpu"),
                                 jport.port_state_dict(sd, v)).eval()
    x = to_torch(np.random.default_rng(0).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        a, b = ported(x), carried(x)
    for g, r in zip(a[0] + a[1], b[0] + b[1]):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
