"""The port's NOMS training path (learn/noms.py) against the JAX package's
on the same numpy inputs: the unrolled twin's posteriors, the soft-BER loss
and its alpha/beta gradients, one Adam step against optax, training on the
CPU, and the schedule JSON both ways."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ecc_ldpc_tpu.codes import get_code as jax_get_code
from ecc_ldpc_tpu.graph import compile_qc_graph as jax_compile_qc_graph
from ecc_ldpc_tpu.learn import load_schedule as jax_load_schedule
from ecc_ldpc_tpu.learn.noms import soft_ber_loss as jax_soft_ber_loss
from ecc_ldpc_tpu.learn.noms import unrolled_posteriors as jax_unrolled
from ecc_ldpc_tpu_torch.cli.main import main as cli_main
from ecc_ldpc_tpu_torch.codes.registry import get_code
from ecc_ldpc_tpu_torch.convert import schedule_from_numpy
from ecc_ldpc_tpu_torch.decode.layered_qc import plain_with_posteriors
from ecc_ldpc_tpu_torch.graph.qc import compile_qc_graph
from ecc_ldpc_tpu_torch.learn import (
    list_schedules,
    load_schedule,
    soft_ber_loss,
    train_noms,
    unrolled_posteriors,
)
from ecc_ldpc_tpu_torch.learn.noms import ALPHA_MAX, ALPHA_MIN

torch.set_num_threads(1)

T, B = 4, 8
# XLA:CPU contracts alpha*m - beta into one fused multiply-add inside the
# compiled scan; the port rounds twice, as the kernels do
POST_TOL = dict(atol=1e-4, rtol=1e-5)
GRAD_RTOL = 1e-4
TOY = "toy16"  # a dup-free circulant code: Z = 16, a 3 x 6 seeded base


def _codes(code):
    """(JAX CodeSpec, the port's CodeSpec) of a registered code or TOY."""
    if code != TOY:
        return jax_get_code(code), get_code(code)
    from ecc_ldpc_tpu.codes.qc import QCCode as JaxQCCode
    from ecc_ldpc_tpu.codes.qc import expand_qc as jax_expand_qc
    from ecc_ldpc_tpu_torch.codes.qc import QCCode, expand_qc

    base = np.random.default_rng(3).integers(-1, 16, size=(3, 6))
    return (jax_expand_qc(JaxQCCode(Z=16, base=base), name=TOY),
            expand_qc(QCCode(Z=16, base=base), name=TOY))


def _case(code):
    jspec, spec = _codes(code)
    rng = np.random.default_rng(5)
    cw = rng.integers(0, 2, (B, spec.n)).astype(np.uint8)
    llr = ((1.0 - 2.0 * cw) * 2.0
           + rng.normal(size=(B, spec.n)) * 1.5).astype(np.float32)
    # random alpha/beta as in tests/learn/test_noms.py
    alphas = rng.uniform(0.6, 1.1, T).astype(np.float32)
    betas = rng.uniform(0.0, 0.3, T).astype(np.float32)
    return dict(code=code, jgraph=jax_compile_qc_graph(jspec),
                graph=compile_qc_graph(spec), cw=cw, llr=llr, alphas=alphas,
                betas=betas)


# dup-free (802.11n; the toy code, whose backward pass XLA:CPU compiles in
# seconds, not the ~20 s of 80211n/648/12's) and a graph whose layers
# repeat a block-column (CCSDS AR4JA: the last edge of a column sets its
# posteriors)
@pytest.fixture(scope="module", params=["80211n/648/12", "ccsds/1024/12"])
def case(request):
    return _case(request.param)


@pytest.fixture(scope="module", params=[TOY, "ccsds/1024/12"])
def grad_case(request):
    c = _case(request.param)

    def f(a, b):
        post = jax_unrolled(c["jgraph"], jnp.asarray(c["llr"]), a, b)
        return jax_soft_ber_loss(post, jnp.asarray(c["cw"]))

    loss, (ga, gb) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(c["alphas"]), jnp.asarray(c["betas"]))
    c["jax_grad"] = (float(loss), np.asarray(ga), np.asarray(gb))
    return c


def test_unrolled_posteriors_match_jax(case):
    pj = np.asarray(jax_unrolled(case["jgraph"], jnp.asarray(case["llr"]),
                                 case["alphas"], case["betas"]))
    pt = unrolled_posteriors(case["graph"], torch.as_tensor(case["llr"]),
                             case["alphas"], case["betas"]).numpy()
    assert pt.shape == pj.shape == (T, B, case["graph"].n)
    np.testing.assert_allclose(pt, pj, **POST_TOL)
    np.testing.assert_array_equal(pt[-1] < 0, pj[-1] < 0)
    # without checkpointing the same numbers
    pn = unrolled_posteriors(case["graph"], torch.as_tensor(case["llr"]),
                             case["alphas"], case["betas"], remat=False)
    assert np.array_equal(pn.numpy(), pt)


def test_twin_matches_plain_decoder_with_count_signs():
    """On a dup-free graph the twin's last posteriors are the plain layered
    decoder's in fixed mode with count signs, bit for bit."""
    graph = compile_qc_graph(get_code("80211n/648/12"))
    rng = np.random.default_rng(11)
    llr = torch.as_tensor((rng.normal(size=(32, graph.n)) * 2.5 + 1.0)
                          .astype(np.float32))
    alphas = rng.uniform(0.6, 1.1, 6).astype(np.float32)
    betas = rng.uniform(0.0, 0.3, 6).astype(np.float32)
    post = unrolled_posteriors(graph, llr, alphas, betas)
    res, total = plain_with_posteriors(graph, llr, alpha=alphas, beta=betas,
                                       max_iters=6, early_term=False,
                                       sign_mode="count")
    assert torch.equal(post[-1], total)
    assert torch.equal((post[-1] < 0).to(torch.uint8), res.bits)
    with pytest.raises(KeyError, match="sign_mode"):
        plain_with_posteriors(graph, llr, sign_mode="signbit")


def _torch_value_and_grad(case):
    a = torch.tensor(case["alphas"], requires_grad=True)
    b = torch.tensor(case["betas"], requires_grad=True)
    loss = soft_ber_loss(
        unrolled_posteriors(case["graph"], torch.as_tensor(case["llr"]), a, b),
        torch.as_tensor(case["cw"]))
    loss.backward()
    return loss.item(), a.grad.numpy(), b.grad.numpy()


def test_loss_and_gradients_match_jax(grad_case):
    lj, gaj, gbj = grad_case["jax_grad"]
    lt, gat, gbt = _torch_value_and_grad(grad_case)
    np.testing.assert_allclose(lt, lj, rtol=GRAD_RTOL)
    scale = max(np.abs(gaj).max(), np.abs(gbj).max())
    np.testing.assert_allclose(gat, gaj, rtol=GRAD_RTOL, atol=GRAD_RTOL * scale)
    np.testing.assert_allclose(gbt, gbj, rtol=GRAD_RTOL, atol=GRAD_RTOL * scale)


def _adam_f64(p, g, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step from zero moments in float64 (the update rule both
    optimizers implement)."""
    p, g = np.float64(p), np.float64(g)
    m, v = (1 - b1) * g, (1 - b2) * g * g
    return p - lr * (m / (1 - b1)) / (np.sqrt(v / (1 - b2)) + eps)


def test_adam_step_matches_optax(grad_case):
    """torch.optim.Adam and optax.adam on the same gradients (the JAX
    ones), the parameters carried across with schedule_from_numpy. optax
    forms its bias correction 1 - b2 in f32 (1 - f32(0.999) is 1.3e-5 off
    0.001), which moves its step by 6.4e-6 of lr; torch forms it in
    float64. So torch is held to the float64 rule at rtol 1e-6, and optax
    to torch at rtol 1e-6 beside an atol of 1e-5 * lr for that rounding."""
    _, ga, gb = grad_case["jax_grad"]
    params = schedule_from_numpy(grad_case["alphas"], grad_case["betas"])
    lr = 0.01
    a = torch.tensor(params.alphas, requires_grad=True)
    b = torch.tensor(params.betas, requires_grad=True)
    opt = torch.optim.Adam([a, b], lr=lr)
    a.grad = torch.tensor(ga)
    b.grad = torch.tensor(gb)
    opt.step()
    jopt = optax.adam(lr)
    jp = (jnp.asarray(params.alphas), jnp.asarray(params.betas))
    updates, _ = jopt.update((jnp.asarray(ga), jnp.asarray(gb)),
                             jopt.init(jp))
    jp = optax.apply_updates(jp, updates)
    for t, j, p0, g in ((a, jp[0], params.alphas, ga),
                        (b, jp[1], params.betas, gb)):
        t = t.detach().numpy()
        np.testing.assert_allclose(t, _adam_f64(p0, g, lr), rtol=1e-6)
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-6, atol=1e-5 * lr)


def test_training_reduces_loss():
    """JAX's test_training_reduces_loss on the CPU (not a parity check: the
    noise streams differ)."""
    params, losses = train_noms("80211n/648/12", iters=5, steps=16, batch=32,
                                seed=1, ebn0_range=(1.5, 2.5), device="cpu")
    assert params.iters == 5 and losses.shape == (16,)
    assert losses[-5:].mean() < losses[:5].mean()
    assert np.all(params.alphas >= ALPHA_MIN)
    assert np.all(params.alphas <= ALPHA_MAX)
    assert np.all(params.betas >= 0.0)


def test_frozen_parameters_stay():
    kw = dict(iters=3, steps=2, batch=8, seed=2, ebn0_range=(1.5, 2.5),
              device="cpu", init_alpha=0.9, init_beta=0.1)
    p, _ = train_noms("80211n/648/12", learn_beta=False, **kw)
    assert np.all(p.betas == np.float32(0.1))
    assert not np.all(p.alphas == np.float32(0.9))
    p, _ = train_noms("80211n/648/12", learn_alpha=False, **kw)
    assert np.all(p.alphas == np.float32(0.9))
    with pytest.raises(RuntimeError, match="CUDA"):
        train_noms("80211n/648/12", iters=2, steps=1, batch=2)


def test_schedule_json_both_ways(tmp_path, capsys):
    """The port's `learn --out` file loads in JAX's load_schedule, and the
    shipped schedules (the JAX CLI's files) in the port's."""
    out = tmp_path / "sched.json"
    assert cli_main(["learn", "--code", "80211n/648/12", "--ebn0", "1.5:2.5",
                     "--iters", "3", "--steps", "2", "--batch", "8",
                     "--device", "cpu", "--out", str(out)]) == 0
    assert "wrote" in capsys.readouterr().out
    d = json.loads(out.read_text())
    assert d["trained"]["ebn0_range_db"] == [1.5, 2.5]
    assert d["iters"] == 3 and d["decoder"] == "layered min-sum"
    jp = jax_load_schedule(str(out))
    tp = load_schedule(str(out))
    assert np.array_equal(np.asarray(jp.alphas), tp.alphas)
    assert np.array_equal(np.asarray(jp.betas), tp.betas)
    for name in list_schedules():
        jp, tp = jax_load_schedule(name), load_schedule(name)
        assert np.array_equal(np.asarray(jp.alphas), tp.alphas)
    with pytest.raises(SystemExit):
        cli_main(["learn", "--ebn0", "2", "--alpha-only", "--beta-only",
                  "--out", str(out)])
