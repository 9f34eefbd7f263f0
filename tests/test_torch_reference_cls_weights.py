"""Reference-layout classification checkpoints (``port_cls_state_dict``)
against the JAX package's ``port_cls_state_dict``, on the CPU; the state
dicts are drawn as in ``test_torch_reference_weights.py``, their names from
the JAX package's ``_cls_prefix``.

* every leaf of the port model equals JAX's for the five families (Q-WRN,
  Q-ResNet CIFAR, Q-ResNet ImageNet, Q-WRN ImageNet, Q-WRN-16 ImageNet);
* the ported Q-WRN's eval logits against the JAX model with the JAX-ported
  variables: max abs error within 1e-4 of max|ref| (the f32 tolerance of
  ``test_torch_classify.py``);
* a missing name raises `KeyError` naming it, a wrong shape `ValueError`, an
  unknown family `ValueError`; keys no leaf reads are ignored.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quan_ultralytics_tpu.classification.models as jmodels
from quan_ultralytics_tpu.utils import torch_port as jport
from quan_ultralytics_tpu_torch.classification import models as tmodels
from quan_ultralytics_tpu_torch.utils import torch_port as tport
from test_torch_reference_weights import _assert_same_leaves
from torch_port_helpers import fill_variables, to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


FAMILIES = {  # name -> (JAX module, port module, input size, torch_port family)
    "QWideResNet": (lambda: jmodels.QWideResNet(10, 1, 10, 0.0, "poincare"),
                    lambda: tmodels.QWideResNet(10, 1, 10, 0.0, "poincare"), 32, None),
    "QResNetCIFAR": (lambda: jmodels.QResNetCIFAR((1, 1, 1), 10, 0.0, 8, "poincare"),
                     lambda: tmodels.QResNetCIFAR((1, 1, 1), 10, 0.0, 8, "poincare"), 32, None),
    "QResNetImageNet": (lambda: jmodels.QResNetImageNet((1, 1, 1, 1), 20, 0.1, 16, "poincare"),
                        lambda: tmodels.QResNetImageNet((1, 1, 1, 1), 20, 0.1, 16, "poincare"), 64, None),
    "QWideResNetImageNet": (lambda: jmodels.QWideResNetImageNet(1, 20, 0.2, "poincare"),
                            lambda: tmodels.QWideResNetImageNet(1, 20, 0.2, "poincare"), 64, "imagenet_wrn"),
    "QWRN16ImageNet": (lambda: jmodels.QWRN16ImageNet(1, 20, 0.2, "poincare"),
                       lambda: tmodels.QWRN16ImageNet(1, 20, 0.2, "poincare"), 64, "imagenet_wrn"),
}


def _cls_case(name, seed):
    make_jax, make_port, size, family = FAMILIES[name]
    jm = make_jax()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))
    v = jax.tree_util.tree_map(np.asarray, fill_variables(shapes, seed))
    fam = family or ("resnet_cifar" if "fc1" in v["params"] else
                     "imagenet_resnet" if "stem_conv" in v["params"] else "wrn_cifar")
    sd = tport.to_reference_state_dict(v, lambda parent: jport._cls_prefix(parent, fam),
                                       dense=("classifier", "fc1", "fc2"))
    return jm, make_port(), v, sd, family, size


def test_classification_state_dict_ports_as_jax_does():
    for name in sorted(FAMILIES):
        _, tm, v, sd, family, _ = _cls_case(name, seed=6)
        ref = jport.port_cls_state_dict(sd, v, family=family)
        tport.port_cls_state_dict(sd, tm, family=family)
        _assert_same_leaves(tm, ref)
        _assert_same_leaves(tm, v)


def test_ported_wrn_logits_match_jax():
    jm, tm, v, sd, family, size = _cls_case("QWideResNet", seed=7)
    x = np.random.default_rng(1).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(jport.port_cls_state_dict(sd, v), jnp.asarray(x))
    tport.port_cls_state_dict(sd, tm).eval()
    with torch.no_grad():
        got = tm(to_torch(x))
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert float(np.abs(got.numpy() - ref).max()) <= 1e-4 * float(np.abs(ref).max())


def test_missing_or_misshapen_reference_keys_raise():
    _, tm, _, sd, _, _ = _cls_case("QWideResNet", seed=8)
    name = next(k for k in sd if k.endswith("weight_j"))
    with pytest.raises(KeyError, match=name.replace(".", r"\.")):
        tport.port_cls_state_dict({k: a for k, a in sd.items() if k != name}, tm)
    bad = dict(sd)
    for comp in "rijk":  # one output channel too many in every component
        key = name[:-1] + comp
        bad[key] = np.zeros((sd[key].shape[0] + 1,) + sd[key].shape[1:], np.float32)
    with pytest.raises(ValueError, match="reference shape"):
        tport.port_cls_state_dict(bad, tm)
    with pytest.raises(ValueError, match="family"):
        tport.port_cls_state_dict(sd, tm, family="vit")
    # keys no leaf reads are ignored, as the JAX package ignores them
    tport.port_cls_state_dict({**sd, "num_batches_tracked": np.zeros(())}, tm)
