"""The op types the 2.0 API calls (``nn``, ``nn.functional``, ``tensor``
and the 2.0 optimizers), each lowering of the port against the
reference's on the same inputs.

Every case of ``paddle_tpu_torch/tools/glue_cases.py`` for these op types
(the ones chip_smoke's ``ops_glue_card`` runs on the card) goes through
both packages' lowerings: edge values (NaN, +-inf, -0.0), ties at each
threshold, negative and out-of-range indices, empty and full
selections, every padding mode, layout variant and optimizer state;
integer outputs bit for bit, floats within their family's tolerance
(``FLOAT_TOL`` of ``test_torch_math_tensor_ops``, 1e-5 for norms and
optimizer updates, 1e-5 for the ``matmul`` family). Gradients of the
differentiable ones: the port's ``__vjp_grad__`` against ``jax.vjp`` of
the reference's lowering, within 2e-5 (5e-5 for warpctc's lattice).
"""

import numpy as np
import pytest

from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.tools.glue_cases import API_OPS, CASES as GLUE_CASES
from paddle_tpu_torch.tools.glue_cases import family, rng as _rng
from tests.test_torch_math_tensor_ops import FLOAT_TOL, check_op, vjp_both

TOL = dict(FLOAT_TOL, norm=1e-5, optimizer=1e-5, tensor=1e-6)
CASES = {c: f for c, f in GLUE_CASES.items() if c.split("[")[0] in API_OPS}
NO_GRAD = {"eye", "linspace", "broadcast_to", "adagrad", "adamax",
           "adadelta", "rmsprop", "decayed_adagrad", "ftrl"}
GRAD_TOL = {"warpctc": 5e-5}


def test_every_api_op_type_is_registered_with_a_case():
    covered = {c.split("[")[0] for c in CASES}
    assert covered == set(API_OPS)
    assert all(pt_registry.lookup(op) is not None for op in API_OPS)
    # with the three interpolate aliases and expand_as_v2, and
    # @to_static's closure op __jax_fn__
    assert len(pt_registry.registered_ops()) == 208 + 36 + 3 + 1
    assert pt_registry.lookup("__jax_fn__") is not None


@pytest.mark.parametrize("case", sorted(CASES))
def test_api_op_matches_the_reference(case):
    op = case.split("[")[0]
    ins, attrs = CASES[case](_rng(case))
    check_op(op, ins, attrs, case, TOL[family(op)])


GRAD_CASES = sorted(c for c in CASES if c.split("[")[0] not in NO_GRAD
                    and "nan" not in c and "edge" not in c
                    and "saturated" not in c and "same" not in c)


@pytest.mark.parametrize("case", GRAD_CASES)
def test_api_op_gradient_matches_the_reference(case):
    op = case.split("[")[0]
    r = _rng(case)
    ins, attrs = CASES[case](r)
    vjp_both(op, ins, attrs, r, GRAD_TOL.get(op, 2e-5))
