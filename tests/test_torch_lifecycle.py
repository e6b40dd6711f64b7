"""The rest of the network's and the trainer's lifecycle in the port, against
the JAX package where it has the same thing: ``set_multiplier``,
``onfly_merge``/``onfly_restore``, each module's ``apply_max_norm``,
``apply_max_norm_regularization``, ``prepare_optimizer_params``, the
trainer's ``scale_weight_norms`` over 2 steps, premerge against the
interceptor route (with every block checkpointed), and a checkpoint resume.

Tolerance: fp32 1e-5 per op and for max-norm's norms and tensors, 1e-4
relative for whole-UNet outputs and losses; premerge and the interceptor
route within 1e-5 of each other (the same ops in another order); the resume
bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lycoris_tpu as jl
import lycoris_tpu_torch as tl
import torch_parity as tp
from lycoris_tpu import modules as jmodules
from lycoris_tpu.modules.base import LayerInfo as JLayerInfo
from lycoris_tpu.modules.locon import LoConModule as JLoCon
from lycoris_tpu.modules.loha import LohaModule as JLoha
from lycoris_tpu.modules.lokr import LokrModule as JLokr
from lycoris_tpu.trainer import DiffusionTrainer as JTrainer
from lycoris_tpu_torch.modules import LayerInfo, get_module, make_module
from lycoris_tpu_torch.trainer import DiffusionTrainer

TOL = dict(atol=1e-5, rtol=1e-5)
REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny UNet runs as fast on one intra-op thread, and the parallel
    test workers then do not oversubscribe the cores (many threads each
    spinning on small ops made these tests some 50x slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def reset_presets():
    yield
    jl.LycorisNetwork.reset_preset()
    tl.LycorisNetwork.reset_preset()


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).detach()), np.asarray(want),
                               **(tol or TOL))


def _args(d):
    return (tuple(jnp.asarray(d[k]) for k in ("lat", "t", "ctx")),
            tuple(torch.tensor(d[k]) for k in ("lat", "t", "ctx")))


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------


def test_set_multiplier_matches_jax():
    model, variables, net, m, tnet, d = tp.setup("lokr")
    jargs, targs = _args(d)
    net.set_multiplier(0.4)
    tnet.set_multiplier(0.4)
    assert tnet.multiplier == 0.4 and all(lyco.multiplier == 0.4 for lyco in tnet.loras)
    want = net({"params": variables["params"]}, *jargs, model=model, merged_forward=True)
    tnet.apply_to(merged_forward=True)
    with torch.no_grad():
        got = m(*targs)
    tnet.restore()
    _close(got, want, atol=REL, rtol=REL)
    with torch.no_grad():
        base = m(*targs)
    assert not torch.allclose(got, base, atol=1e-3)


@pytest.mark.parametrize("algo", ["loha", "lora"])
def test_onfly_merge_and_restore(algo):
    """``onfly_merge`` gives every adapted layer the JAX ``merge_to``
    weight, the plain model then equals the live adapters, and
    ``onfly_restore`` puts back every base weight bit for bit."""
    model, variables, net, m, tnet, d = tp.setup(algo, dora_wd=algo == "loha")
    jargs, targs = _args(d)
    tnet.apply_to(merged_forward=True)
    with torch.no_grad():
        live = m(*targs)
    with pytest.raises(RuntimeError, match="applied"):
        tnet.onfly_merge(1.0)
    tnet.restore()
    before = {k: v.clone() for k, v in m.state_dict().items()}
    tnet.onfly_merge(1.0)
    merged_jax = tl.models.unet.state_dict_from_jax(net.merge_to(1.0))
    for k, v in m.state_dict().items():
        _close(v, merged_jax[k])
    with torch.no_grad():
        _close(m(*targs), live, atol=REL, rtol=REL)
    tnet.onfly_restore()
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k]), k


def _max_norm_pair(algo, kw, shape):
    rng = np.random.default_rng(0)
    if len(shape) == 2:
        jli, tli = JLayerInfo.linear(*shape), LayerInfo.linear(*shape)
    else:
        jli = JLayerInfo.conv(2, *shape[:2], tuple(shape[2:]), padding=1)
        tli = LayerInfo.conv(2, *shape[:2], tuple(shape[2:]), padding=1)
    jcls = {"locon": JLoCon, "loha": JLoha, "lokr": JLokr}[algo]
    jm = jcls("t", jli, 1.0, 4, 2.0, rng=jax.random.key(0), **kw)
    for k in sorted(jm.trainable):
        jm.params[k] = jm.params[k] + jnp.asarray(
            rng.standard_normal(jm.params[k].shape).astype(np.float32) * 0.2)
    # both modules from the same state dict (a LoKr module whose w1 and w2
    # are both full reloads with alpha = rank in both packages)
    sd = {f"t.{k}": np.asarray(v) for k, v in jm.custom_state_dict().items()}
    jtype, jparams = jmodules.get_module(sd, "t")
    jm = jmodules.make_module(jtype, jparams, "t", jli)
    ttype, params = get_module(sd, "t")
    tm = make_module(ttype, [None if p is None else torch.tensor(p) for p in params], "t", tli)
    return jm, tm


@pytest.mark.parametrize("algo,kw,shape", [
    ("locon", {}, (64, 48)), ("locon", {"use_tucker": True}, (64, 48, 3, 3)),
    ("loha", {}, (64, 48)), ("loha", {"weight_decompose": True}, (64, 48, 3, 3)),
    ("lokr", {"factor": 4}, (64, 48)), ("lokr", {"factor": 4, "use_tucker": True}, (64, 48, 3, 3)),
    ("lokr", {"factor": 4, "decompose_both": True}, (64, 48)),
    ("lokr", {"factor": -1}, (64, 48))])
def test_module_apply_max_norm_matches_jax(algo, kw, shape):
    """Scaled (the limit a third of the norm) and under the limit (twice the
    norm): the flag, the norm after scaling and every tensor."""
    jm, tm = _max_norm_pair(algo, kw, shape)
    norm = float(np.linalg.norm(np.asarray(jm.get_diff_weight()[0]).ravel()))
    for limit, want_scaled in ((norm / 3, True), (2 * norm, False)):
        jp, jscaled, jnorm = jm.apply_max_norm(limit)
        tp_, tscaled, tnorm = tm.apply_max_norm(limit)
        assert bool(tscaled) == bool(jscaled) == want_scaled
        assert tscaled.dtype == torch.bool and tnorm.ndim == 0
        _close(tnorm, jnorm)
        assert set(tp_) == set(jp)
        for k in jp:
            _close(tp_[k], jp[k])
        jm.params = jp
    assert float(tm.get_diff_weight()[0].detach().norm()) <= norm / 3 * (1 + 1e-5)


def test_apply_max_norm_regularization_matches_jax():
    _, _, net, _, tnet, _ = tp.setup("loha")
    norms = [float(lyco.get_diff_weight()[0].detach().norm()) for lyco in tnet.loras]
    limit = float(np.median(norms))
    want = net.apply_max_norm_regularization(limit)
    got = tnet.apply_max_norm_regularization(limit)
    assert got[0] == want[1] and 0 < got[0] < len(tnet.loras)
    np.testing.assert_allclose(got[1:], want[2:], rtol=1e-5)
    for ln, p in want[0].items():
        for k, v in p.items():
            _close(tnet.lora_map[ln].params[k], v)
    assert tnet.apply_max_norm_regularization(limit * 10) == (0, 0, 0)


def test_prepare_optimizer_params():
    _, _, net, _, tnet, _ = tp.setup("lokr", dora_wd=True)
    (group,) = tnet.prepare_optimizer_params(3e-4)
    assert group["lr"] == 3e-4 and "lr" not in tnet.prepare_optimizer_params()[0]
    want = [(ln, k) for ln, sub in net.trainable_params().items() for k in sub]
    got = {id(p) for p in group["params"]}
    assert len(group["params"]) == len(want) == len(got)
    assert got == {id(tnet.lora_map[ln].params[k]) for ln, k in want}
    assert tnet.get_trainable_params().keys() == net.get_trainable_params().keys()
    torch.optim.AdamW(tnet.prepare_optimizer_params(1e-3))


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _jax_draws(rng, batch):
    """The JAX trainer's noise and timesteps for ``rng`` (trainer.py:163-166)."""
    noise_rng, t_rng, _ = jax.random.split(rng, 3)
    b = batch.shape[0]
    noise = jax.random.normal(noise_rng, batch.shape, dtype=jnp.float32)
    t = jax.random.randint(t_rng, (b,), 0, 1000)
    return torch.tensor(np.asarray(noise)), torch.tensor(np.asarray(t)).long()


@pytest.mark.parametrize("algo", ["loha", "lokr"])
def test_scale_weight_norms_matches_jax_trainer(algo):
    """Two steps with max-norm at half the median of the modules' norms
    (some scaled, some not), on the JAX trainer's noise and timesteps: the
    stats and every adapter tensor equal the JAX trainer's."""
    model, variables, net, m, tnet, d = tp.setup(algo, batch=8)
    limit = 0.5 * float(np.median([float(lyco.get_diff_weight()[0].detach().norm())
                                   for lyco in tnet.loras]))
    jtr = JTrainer(model, variables, net, lr=1e-3, weight_dtype=jnp.float32,
                   scale_weight_norms=limit)
    tr = DiffusionTrainer(m, tnet, lr=1e-3, weight_dtype=torch.float32,
                          scale_weight_norms=limit)
    batch = {"latents": d["lat"], "context": d["ctx"]}
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    for i in range(2):
        rng = jax.random.key(10 + i)
        jloss = float(jtr.train_step({k: jnp.asarray(v) for k, v in batch.items()}, rng))
        loss = float(tr._step(tbatch, *_jax_draws(rng, d["lat"]), seed=0))
        np.testing.assert_allclose(loss, jloss, rtol=REL)
        assert all(s.ndim == 0 for s in tr.max_norm_stats)
        jstats = [float(s) for s in jtr.max_norm_stats]
        stats = [float(s) for s in tr.max_norm_stats]
        assert stats[0] == jstats[0] and 0 < stats[0] < len(tnet.loras)
        np.testing.assert_allclose(stats[1:], jstats[1:], rtol=1e-5)
        assert stats[2] <= limit * (1 + 1e-3)
    jtr.sync_to_network()
    for ln, lyco in tnet.lora_map.items():
        for k, v in net.lora_map[ln].params.items():
            # alpha is not trained; a LoKr layer whose w1 and w2 are both
            # full reloads it as its rank (the same dW)
            if k != "alpha":
                _close(lyco.params[k], v)


def _pair_of_trainers(algo, remat, **kw):
    """Two port trainers on two copies of the tiny UNet (``remat``) with
    the same adapters and generator seed, premerge and interceptor."""
    _, variables, net, _, _, d = tp.setup(algo, **kw)
    sd = {k: torch.tensor(np.array(v)) for k, v in net.state_dict().items()}
    trainers = []
    for mode in ("premerge", "interceptor"):
        m = tp.port_unet(variables, remat)
        tnet, _ = tl.create_lycoris_from_weights(1.0, None, m, weights_sd=sd, device="cpu")
        trainers.append(DiffusionTrainer(m, tnet, lr=1e-3, weight_dtype=torch.float32,
                                         merge_mode=mode,
                                         generator=torch.Generator().manual_seed(4)))
    return trainers, d


def _grads(tr):
    return {ln: {k: p.grad.clone() for k, p in sub.items()}
            for ln, sub in tr.net.trainable_params().items()}


@pytest.mark.parametrize("algo,kw", [("lokr", {}), ("loha", {"dora_wd": True})])
def test_premerge_matches_interceptor_under_remat(algo, kw):
    """Every block checkpointed (``remat=True``): premerge's loss and
    gradients equal the interceptor route's to 1e-5, then 3 steps keep the
    losses together (JAX tests/test_premerge.py). Premerge runs no adapter
    forward, so the network is not applied."""
    (pre, inter), d = _pair_of_trainers(algo, True, **kw)
    assert not pre.net._patched and inter.net._patched
    args = (torch.tensor(d["lat"]), torch.tensor(d["ctx"]), torch.tensor(d["noise"]),
            torch.tensor(d["t"]).long())
    losses = []
    for tr in (pre, inter):
        with tr.adapted():
            loss = tr.loss_fn(*args)
            loss.backward()
        losses.append(float(loss))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    tp.assert_trees_close(_grads(pre), _grads(inter), 1e-5)
    batch = {"latents": args[0], "context": args[1]}
    for _ in range(3):
        la, lb = float(pre.train_step(batch)), float(inter.train_step(batch))
        np.testing.assert_allclose(la, lb, rtol=REL)


def test_premerge_backward_outside_the_block_fails():
    """The trap the premerged block avoids: with the backward outside it,
    the recompute of the checkpointed blocks reads the base weights. Here
    the base weights need no gradient, so the recompute saves fewer tensors
    and torch's checkpoint raises; where it would not, the gradients would
    be wrong."""
    (pre, inter), d = _pair_of_trainers("lokr", True)
    args = (torch.tensor(d["lat"]), torch.tensor(d["ctx"]), torch.tensor(d["noise"]),
            torch.tensor(d["t"]).long())
    with pre.adapted():
        loss = pre.loss_fn(*args)
    try:
        loss.backward()
    except torch.utils.checkpoint.CheckpointError:
        return
    inter.loss_fn(*args).backward()
    g = torch.cat([v.reshape(-1) for sub in _grads(pre).values() for v in sub.values()])
    w = torch.cat([v.reshape(-1) for sub in _grads(inter).values() for v in sub.values()])
    assert float((g - w).norm() / w.norm()) > 1e-3


def test_premerge_refuses_an_applied_network():
    _, _, _, m, tnet, _ = tp.setup("lokr")
    tnet.apply_to()
    with pytest.raises(RuntimeError, match="applied"):
        with tnet.premerged():
            pass
    tnet.restore()
    params = [id(p) for p in m.parameters()]
    with tnet.premerged():
        assert any(not isinstance(p, torch.nn.Parameter) for p in m.parameters())
    assert [id(p) for p in m.parameters()] == params


def test_checkpoint_resume_is_bit_for_bit(tmp_path):
    """2 steps, save, load into a fresh trainer (other adapter values, a
    fresh optimizer, generators at other seeds); then one more step on each
    gives the same loss and tensors, bit for bit."""
    _, variables, net, _, _, d = tp.setup("lokr", dora_wd=True)
    sd = {k: torch.tensor(np.array(v)) for k, v in net.state_dict().items()}
    batch = {"latents": torch.tensor(d["lat"]), "context": torch.tensor(d["ctx"])}

    def trainer(seed):
        m = tp.port_unet(variables)
        tnet, _ = tl.create_lycoris_from_weights(1.0, None, m, weights_sd=sd, device="cpu")
        with torch.no_grad():
            for p in tnet.parameters():
                p.add_(float(seed))
        return DiffusionTrainer(m, tnet, lr=1e-3, weight_dtype=torch.float32,
                                scale_weight_norms=1.0,
                                generator=torch.Generator().manual_seed(seed))

    a = trainer(0)
    for _ in range(2):
        a.train_step(batch)
    path = str(tmp_path / "ckpt.pt")
    a.save_checkpoint(path)
    b = trainer(7)
    b.load_checkpoint(path)
    assert b.step == a.step == 2
    assert torch.equal(b.generator.get_state(), a.generator.get_state())
    assert torch.equal(b.drop_generator.get_state(), a.drop_generator.get_state())
    la, lb = a.train_step(batch), b.train_step(batch)
    assert torch.equal(la, lb)
    for (ka, va), (kb, vb) in zip(a.net.named_parameters(), b.net.named_parameters()):
        assert ka == kb and torch.equal(va, vb), ka
    for (ka, va), (kb, vb) in zip(a.net.named_buffers(), b.net.named_buffers()):
        assert ka == kb and torch.equal(va, vb), ka
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
