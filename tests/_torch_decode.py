"""The reduced model both decode test files drive: llama3.2-1b reduced, in
float32 compute, in the JAX package and in the port, with the JAX
package's parameters in both (a module-scoped fixture, imported by
``tests/test_torch_decode.py`` and ``tests/test_torch_decode_engine.py``)."""

import dataclasses

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jax_build_model
from repro_torch import configs
from repro_torch.models.zoo import build_model, params_from_numpy

from _torch_parity import tree_np

INF = float("inf")


@pytest.fixture(scope="module")
def models():
    """Reduced llama3.2-1b in float32 compute in both packages, the JAX
    package's parameters in both: ``(jax model, port model, jax params,
    port params)``."""
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get("llama3.2-1b")),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(configs.reduced(configs.get("llama3.2-1b")),
                               compute_dtype="float32")
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp, params_from_numpy(tree_np(jp), torch.device("cpu"))
