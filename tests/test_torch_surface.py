"""The port's package surface against the JAX package's: the module-level
``bypass_forward_diff`` of Diag-OFT, BOFT, (IA)^3 and GLoRA (and that each
bypass forward is the base output plus it), ``tucker_weight`` and
``tucker_weight_from_conv``, ``FUNC_LIST`` and the ``functional``
re-exports, ``make_module``/``kohya`` at the top level and
``utils.read_preset``; and ``DiffusionTrainer(num_train_timesteps=...)``
against the JAX trainer's schedule and noising on the tiny UNet.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lycoris_tpu as jl
import lycoris_tpu_torch as tl
import torch_parity as tp
from lycoris_tpu.functional import general as jgeneral
from lycoris_tpu.trainer import DiffusionTrainer as JTrainer
from lycoris_tpu_torch.functional import general as tgeneral
from lycoris_tpu_torch.trainer import DiffusionTrainer
from test_torch_algos import _jax_module, _layer, _port_module

TOL = dict(atol=1e-5, rtol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def reset_presets():
    yield
    jl.LycorisNetwork.reset_preset()
    tl.LycorisNetwork.reset_preset()


@pytest.mark.parametrize("algo", ["diag-oft", "diag-oft-plain", "boft", "boft-plain", "ia3",
                                  "ia3-input", "glora", "glora-scalar"])
@pytest.mark.parametrize("kind", ["linear", "conv"])
@pytest.mark.parametrize("scale", [1.0, 0.6])
def test_bypass_forward_diff_matches_jax(algo, kind, scale):
    jm, tli, w, b, x = _jax_module(algo, kind, seed=3)
    tm = _port_module(algo, jm, tli)
    jli = _layer(kind)[0]
    want = jm.bypass_forward_diff(
        jnp.asarray(x), scale=scale, org_forward=lambda z: jli.op(z, jnp.asarray(w), jnp.asarray(b)))
    tw, tb, tx = torch.tensor(w), torch.tensor(b), torch.tensor(x)
    got = tm.bypass_forward_diff(tx, scale=scale, org_forward=lambda z: tli.op(z, tw, tb))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    # the bypass forward is the base output plus the delta (not for the
    # (IA)^3 input form and GLoRA, whose delta runs the base op on its own
    # input and so carries the layer's bias once more)
    if algo not in ("ia3-input", "glora", "glora-scalar"):
        tm.bypass_mode = True
        full = tm(tx, tw, tb, multiplier=scale)
        torch.testing.assert_close(full, tli.op(tx, tw, tb) + got, **TOL)
    with pytest.raises(ValueError, match="org_forward"):
        tm.bypass_forward_diff(tx, scale=scale)


@pytest.mark.parametrize("k", [(), (3,), (3, 3)])
def test_tucker_weights_match_jax(k):
    rng = np.random.default_rng(4)
    wa = rng.standard_normal((4, 12)).astype(np.float32)
    wb = rng.standard_normal((4, 10)).astype(np.float32)
    t = rng.standard_normal((4, 4, *k)).astype(np.float32)
    want = jgeneral.tucker_weight(jnp.asarray(wa), jnp.asarray(wb), jnp.asarray(t))
    got = tgeneral.tucker_weight(torch.tensor(wa), torch.tensor(wb), torch.tensor(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    up = rng.standard_normal((12, 4, 1, 1)).astype(np.float32)
    down = rng.standard_normal((4, 10, 1, 1)).astype(np.float32)
    want = jgeneral.tucker_weight_from_conv(jnp.asarray(up), jnp.asarray(down), jnp.asarray(t))
    got = tgeneral.tucker_weight_from_conv(torch.tensor(up), torch.tensor(down), torch.tensor(t))
    assert got.shape == (12, 10, *k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_functional_surface():
    assert [f is None for f in tl.functional.FUNC_LIST] == [f is None for f in
                                                             jl.functional.FUNC_LIST]
    assert tl.functional.FUNC_LIST[2] is tgeneral.linear
    assert all(tl.functional.FUNC_LIST[n] is tgeneral.convnd for n in (3, 4, 5))
    for n in (2, 3, 4, 5):
        assert tl.functional.FUNC_LIST[n] is tgeneral.op_by_ndim(n)
    assert set(jl.functional.__all__) <= set(tl.functional.__all__)
    for name in jl.functional.__all__:
        assert getattr(tl.functional, name) is not None, name
    assert tl.functional.factorization(1280, 8) == jl.functional.factorization(1280, 8)
    assert tl.functional.power2factorization(1280, 16) == jl.functional.power2factorization(1280, 16)


def test_top_level_surface():
    for name in ("make_module", "kohya", "utils", "__version__"):
        assert name in tl.__all__ and hasattr(tl, name), name
    assert set(jl.__all__) <= set(tl.__all__)
    assert tl.kohya.create_network is not None
    # make_module at the top level builds the same module as the JAX one
    rng = np.random.default_rng(5)
    sd = {"m.lora_down.weight": rng.standard_normal((4, 24)).astype(np.float32),
          "m.lora_up.weight": rng.standard_normal((32, 4)).astype(np.float32),
          "m.alpha": np.float32(2.0)}
    jtype, jparams = jl.modules.get_module(sd, "m")
    jm = jl.make_module(jtype, jparams, "m", jl.modules.base.LayerInfo.linear(32, 24))
    ttype, tparams = tl.modules.get_module({k: torch.tensor(v) for k, v in sd.items()}, "m")
    tm = tl.make_module(ttype, tparams, "m", tl.modules.LayerInfo.linear(32, 24))
    assert type(tm).__name__ == type(jm).__name__
    np.testing.assert_allclose(tm.get_diff_weight()[0].detach().numpy(),
                               np.asarray(jm.get_diff_weight()[0]), **TOL)


def test_read_preset():
    path = os.path.join(REPO, "example_configs")
    for f in ("preset_example.toml", os.path.join("training_configs", "lokr_sdxl_tpu.toml")):
        got = tl.utils.read_preset(os.path.join(path, f))
        assert got and got == jl.utils.read_preset(os.path.join(path, f))
    assert tl.utils.read_preset(os.path.join(path, "no_such_file.toml")) is None


def test_trainer_num_train_timesteps_matches_jax():
    """At 500 train timesteps the port's schedule is the JAX trainer's, and
    its loss on the JAX trainer's noising (its noise and its timesteps, all
    under 500) is the JAX loss; its own draws stay under 500."""
    model, variables, net, m, tnet, d = tp.setup("lokr")
    jtr = JTrainer(model, variables, net, lr=1e-3, weight_dtype=jnp.float32,
                   num_train_timesteps=500)
    tr = DiffusionTrainer(m, tnet, lr=1e-3, weight_dtype=torch.float32, num_train_timesteps=500)
    assert tr.num_train_timesteps == jtr.num_train_timesteps == 500
    np.testing.assert_array_equal(tr.alphas_cumprod.numpy(), np.asarray(jtr.alphas_cumprod))
    assert DiffusionTrainer(m, tnet, weight_dtype=torch.float32).alphas_cumprod.shape == (1000,)

    acp = jtr.alphas_cumprod
    b = d["lat"].shape[0]
    noise_rng, t_rng, _ = jax.random.split(jax.random.key(7), 3)
    noise = jax.random.normal(noise_rng, d["lat"].shape, dtype=jnp.float32)
    t = jax.random.randint(t_rng, (b,), 0, acp.shape[0])
    a = jnp.take(acp, t).reshape(b, 1, 1, 1)
    noisy = jnp.sqrt(a) * jnp.asarray(d["lat"]) + jnp.sqrt(1 - a) * noise
    fwd = jax.jit(lambda v, x, tt, c: net(v, x, tt, c, model=model, merged_forward=True))
    pred = fwd({"params": variables["params"]}, noisy.astype(jnp.float32), t, jnp.asarray(d["ctx"]))
    jloss = float(jnp.mean((pred.astype(jnp.float32) - noise) ** 2))
    with torch.no_grad():
        loss = tr.loss_fn(torch.tensor(d["lat"]), torch.tensor(d["ctx"]),
                          torch.tensor(np.asarray(noise)), torch.tensor(np.asarray(t)).long())
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)

    # train_step's draws (``_draw``, inside its forward span), without the steps
    drawn = torch.cat([tr._draw(torch.tensor(d["lat"]))[1] for _ in range(20)])
    assert int(drawn.max()) < 500 and int(drawn.max()) >= 250
