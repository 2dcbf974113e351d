"""PyTorch port, the LM training path ≡ the JAX package's, on the CPU:
attention variants: qwen3-32b (qk-norm) and h2o-danube-1.8b (sliding
window) in float32 with LES groups, qwen2-vl-72b (M-RoPE, stub embeddings)
at its own dtype with LES groups, whisper-large-v3 (encoder-decoder,
whose decoder takes no LES groups, as in JAX) in float32.

Each case starts from the port's ``init_state(PRNGKey(0))`` (JAX's
within ``INIT_TOL``, ``test_torch_lm_models.py``), handed to both, and one
seeded batch, and holds the port's ``train_loss`` metrics, its gradients
and 3 AdamW steps (``trainer.train_step``) against JAX's.  One case an
arch (one JAX compile, shared by the case's two tests), the variants
spread over the archs: across the three files the archs run in float32
and at their own dtype, with and without 2 LES groups, and llama3.2-1b
also on the int8 MLP path.

Tolerances (stated in ``tests/_torch_lm.py``): ε is the port's own
rounding level, from a float64 run of the same gradient; the loss metrics
lie within ε (relative), each gradient leaf within 3 ε of JAX's; over the
steps, each loss and grad norm likewise, the lr schedule to float32
rounding, AdamW's mu within 3 ε and nu within 6 ε after each step, and
every parameter within 2.01 · Σ lr of JAX's (AdamW moves a coordinate at
most about lr a step, whatever the gradient's rounding).  Then one AdamW
update of each package on the same state and gradient (JAX's), clipped
and not: params, mu, nu and grad norm within 2⁻²⁰ (float32 rounding).
"""

import pytest

from _torch_lm import (case_id, check_loss_and_grads, check_steps, check_update,  # noqa: F401
                       runs)

CASES = [("qwen3-32b", dict(f32=True, les=2)), ("h2o-danube-1.8b", dict(f32=True, les=2)),
         ("qwen2-vl-72b", dict(les=2)), ("whisper-large-v3", dict(f32=True))]


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_train_loss_and_gradients(runs, case):
    check_loss_and_grads(runs(case), case_id(case))


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_adamw_steps(runs, case):
    check_steps(runs(case), case_id(case))


@pytest.mark.parametrize("gain", [0.5, 4.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_adamw_update_on_one_gradient(runs, case, gain):
    check_update(runs(case), case_id(case), gain)
