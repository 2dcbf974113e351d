"""PyTorch port, the LM models' initialisation and configs ≡ the JAX
package's, on the CPU: ``prng.normal`` against ``jax.random.normal`` (the
uniform draw bitwise, the erfinv to a stated number of ulps), every layer
kind's ``init_params(PRNGKey(0))`` leaf for leaf, and the ten archs' smoke
and published configs, logical-axis tables and parameter counts.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_lm import dev
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget
from repro.models import transformer as jT
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_smoke_config as tget
from repro_torch.configs import list_archs
from repro_torch.core import prng
from repro_torch.models import transformer as tT
from repro_torch.parallel.tree import leaves


#: init draws: ``jax.random.normal``'s erfinv (XLA's float32 polynomial)
#: lies up to 31 float32 ulps from float64's √2·erfinv of the same uniform
#: draw in its tail (|x| > 3), ``torch.erfinv`` within 1.5 (the float64
#: run in ``test_normal_matches_jax_within_erfinv``); 2^-16 of a tensor's
#: largest value covers 64 ulps of it
INIT_TOL = 2.0 ** -16


def test_normal_matches_jax_within_erfinv():
    """``prng.normal``: the uniform draw bit for bit JAX's, the erfinv
    torch's; both against float64's erfinv of the same draw, in ulps."""
    key = prng.PRNGKey(7)
    got = prng.normal(key, (4096,)).double().numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (4096,))).astype(np.float64)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = prng.uniform(key, (4096,), float(lo), 1.0).double()
    exact = (torch.erfinv(u) * np.sqrt(2.0)).numpy()
    ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    assert (np.abs(got - exact) / ulp).max() <= 2
    assert (np.abs(want - exact) / ulp).max() <= 32
    assert dev(got, want) <= INIT_TOL


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-3b", "olmoe-1b-7b",
                                  "whisper-large-v3"])
def test_init_params(arch):
    """init_params(PRNGKey(0)) for each layer kind (rec + local_attn + the
    dense MLP, rwkv, MoE, encoder + self/cross attn): JAX's tree, leaf for
    leaf in shape and dtype, values within ``INIT_TOL``."""
    jc = jget(arch)
    jp = jax.jit(lambda k: jT.init_params(k, jc))(jax.random.PRNGKey(0))
    tp = tT.init_params(prng.PRNGKey(0), tget(arch), device="cpu")
    jl, tl = jax.tree.leaves(jp), leaves(tp)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        assert dev(a, np.asarray(b)) <= INIT_TOL


@pytest.mark.parametrize("arch", list_archs())
def test_configs_and_logical_axes(arch):
    """The smoke and published configs field for field (dtype aside), the
    logical-axis tables, the parameter counts."""
    for jf, tf in ((jget(arch), tget(arch)), (jget_config(arch), tget_config(arch))):
        jd, td = dataclasses.asdict(jf), dataclasses.asdict(tf)
        assert str(jd.pop("dtype").dtype) == str(td.pop("dtype")).replace("torch.", "")
        assert jd == td
        assert tT.logical_axes(tf) == jT.logical_axes(jf)
        assert (tf.param_count(), tf.active_param_count(), tf.scan_repeats, tf.q_per_kv) == \
            (jf.param_count(), jf.active_param_count(), jf.scan_repeats, jf.q_per_kv)
