"""``onnxstream_tpu_torch.entry`` against ``__graft_entry__.py`` on the CPU.

``entry("tiny", device="cpu")`` returns the TINY UNet's forward in bf16 as
``fn(weights, acts)`` with its example arguments: the same weight names in
the same order as JAX's ``entry("tiny")``, an output within 5e-2 * max|out|
of ``jax.jit(fn)(weights, acts)`` (the bf16 TINY bar), and bit for bit the
port's own ``Session.run`` of the graph. The full-width SD1.5 call runs on
the card (``chip_smoke.py phase_entry``).
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from onnxstream_tpu_torch import entry as port_entry

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def both():
    fn, (weights, acts) = port_entry.entry("tiny", device=CPU)
    jfn, (jweights, jacts) = jax_entry.entry("tiny")
    return (fn, weights, acts), (jfn, jweights, jacts)


def test_entry_matches_jax_entry(both):
    (fn, weights, acts), (jfn, jweights, jacts) = both
    assert [tuple(w.shape) for w in weights] == [tuple(np.shape(w)) for w in jweights]
    assert [str(w.dtype).split(".")[-1] for w in weights] == [str(w.dtype) for w in jweights]
    assert set(acts) == set(jacts)
    for k in acts:
        np.testing.assert_array_equal(acts[k], jacts[k])
    y = fn(weights, acts)["out_sample"].float().numpy()
    jy = np.asarray(jax.jit(jfn)(jweights, jacts)["out_sample"], np.float32)
    assert y.shape == jy.shape == (1, 4, 16, 16)
    np.testing.assert_allclose(y, jy, rtol=0, atol=5e-2 * np.abs(jy).max())


def test_entry_weights_follow_the_plan_and_equal_session_run():
    s, inputs = port_entry.build_session("tiny", device=CPU)
    fn, (weights, acts) = port_entry.session_entry(s, inputs)
    ex = s._executor()
    names = [w.name for w in ex.plan.arg_weights]
    jax_s, _, _, jax_inputs = jax_entry._build_session("tiny")
    for k, v in jax_inputs.items():
        jax_s.add_tensor(k, v)
    assert names == [w.name for w in jax_s._executor().plan.arg_weights]
    assert all(w.dtype == torch.bfloat16 for w in weights)
    want = s.run()["out_sample"]
    np.testing.assert_array_equal(fn(weights, acts)["out_sample"].float().numpy(), want)


def test_entry_runs_on_the_card_unless_asked_and_carries_the_dry_run():
    from onnxstream_tpu_torch.parallel import dryrun

    assert port_entry.dryrun_multichip is dryrun.dryrun_multichip
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry("tiny")
