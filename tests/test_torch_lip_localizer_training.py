"""The lip localizer's training half in the port against the JAX package's:
``init_params`` (bit-equal for one seed), ``LipLocalizerNet`` against the
numpy and ``jax.numpy`` forwards (1e-5), the flat parameter round trip
(exact), three Adam + Huber steps against optax (loss within 1e-5
relative, parameters within 1e-4 of each tensor's largest), the renderer
against ``scripts/train_lip_localizer.py``'s (equal), and the trainer's
``main`` end to end on the CPU.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lipsync_tpu.preprocessing import lip_localizer as j_ll
from lipsync_tpu_torch.preprocessing import lip_localizer as ll
from lipsync_tpu_torch.tools import train_lip_localizer as tool

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data():
    px, ty = tool.build_dataset(48, 0)
    return px, ty


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_init_params_bit_equal_to_jax(seed):
    got = ll.init_params(np.random.RandomState(seed))
    want = j_ll.init_params(np.random.RandomState(seed))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("weights", ["init", "shipped"])
def test_net_forward_matches_numpy_and_jax(weights, data):
    params = (ll.init_params(np.random.RandomState(1)) if weights == "init"
              else ll.LipLocalizer.load().params)
    x = data[0][:16]
    net = ll.LipLocalizerNet.from_params(params)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    with jax.default_matmul_precision("highest"):
        want_jax = np.asarray(j_ll.forward(
            jnp, {k: jnp.asarray(v) for k, v in params.items()},
            jnp.asarray(x)))
    want_np = ll.forward(params, x)
    np.testing.assert_allclose(got, want_np, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, want_jax, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(want_np, j_ll.forward(np, params, x))


def test_params_round_trip_exactly():
    params = ll.LipLocalizer.load().params
    back = ll.LipLocalizerNet.from_params(params).to_params()
    assert sorted(back) == sorted(params)
    for k, v in params.items():
        assert back[k].dtype == np.float32 and back[k].shape == v.shape
        np.testing.assert_array_equal(back[k], v)


def test_three_adam_huber_steps_match_optax(data):
    """The script's step (``optax.adam`` + ``optax.huber_loss(delta=0.1)``)
    and the port's (``torch.optim.Adam`` + ``F.huber_loss(delta=0.1)``) on
    the same batches from ``RandomState(seed + 7)``."""
    px, ty = data
    lr, batch = 3e-3, 16
    init = ll.init_params(np.random.RandomState(1))
    params = {k: jnp.asarray(v) for k, v in init.items()}
    tx = optax.adam(lr)
    opt_state = tx.init(params)

    def loss_fn(p, x, y):
        return optax.huber_loss(j_ll.forward(jnp, p, x), y, delta=0.1).mean()

    @jax.jit
    def step(p, s, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(p, x, y)
        updates, s = tx.update(grads, s)
        return optax.apply_updates(p, updates), s, loss

    net = ll.LipLocalizerNet.from_params(init)
    opt = tool.make_optimizer(net, lr)
    rng = np.random.RandomState(0 + 7)
    for _ in range(3):
        idx = rng.randint(0, len(px), size=batch)
        with jax.default_matmul_precision("highest"):
            params, opt_state, j_loss = step(params, opt_state,
                                             jnp.asarray(px[idx]),
                                             jnp.asarray(ty[idx]))
        loss = tool.train_step(net, opt, torch.from_numpy(px[idx]),
                               torch.from_numpy(ty[idx]))
        assert abs(float(loss) - float(j_loss)) <= 1e-5 * abs(float(j_loss))
        got = net.to_params()
        for k, v in params.items():
            v = np.asarray(v)
            assert np.abs(got[k] - v).max() <= 1e-4 * np.abs(v).max(), k


def test_renderer_equals_the_scripts():
    import train_lip_localizer as script

    rng_a, rng_b = np.random.RandomState(3), np.random.RandomState(3)
    skipped = 0
    for _ in range(25):
        a, b = tool.render_training_face(rng_a), script.render_training_face(
            rng_b)
        assert (a is None) == (b is None)
        if a is None:
            skipped += 1
            continue
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    assert skipped < 25
    pa, ta = tool.build_dataset(12, 5)
    pb, tb = script.build_dataset(12, 5)
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(ta, tb)


def test_val_iou_on_known_boxes():
    """Boxes clipped to the patch: equal -> 1, disjoint -> 0, a box and its
    half -> 1/2, two boxes overlapping by half of each -> 1/3."""
    pred = np.array([[0.1, 0.1, 0.5, 0.5], [0.0, 0.0, 0.2, 0.2],
                     [0.0, 0.0, 0.5, 1.0], [0.0, 0.0, 0.5, 1.0],
                     [-0.5, 0.0, 0.5, 1.0]], np.float32)
    tgt = np.array([[0.1, 0.1, 0.5, 0.5], [0.5, 0.5, 0.9, 0.9],
                    [0.0, 0.0, 1.0, 1.0], [0.25, 0.0, 0.75, 1.0],
                    [0.0, 0.0, 1.0, 1.0]], np.float32)
    np.testing.assert_allclose(tool.val_iou(pred, tgt),
                               [1.0, 0.0, 0.5, 1 / 3, 0.5], rtol=1e-6)


def test_main_writes_weights_both_packages_load(tmp_path, capsys):
    out = tmp_path / "ll.npz"
    assert tool.main(["--device", "cpu", "--n-train", "64", "--n-val", "16",
                      "--steps", "3", "--out", str(out)]) == 0
    port, jax_loaded = ll.LipLocalizer.load(out), j_ll.LipLocalizer.load(out)
    assert sorted(port.params) == sorted(jax_loaded.params) == sorted(
        ll.init_params(np.random.RandomState(0)))
    x = tool.build_dataset(4, 10_000)[0]
    np.testing.assert_array_equal(ll.forward(port.params, x),
                                  j_ll.forward(np, jax_loaded.params, x))
    meta = json.loads(out.with_suffix(".json").read_text())
    assert sorted(meta) == sorted(json.loads(
        ll.DEFAULT_WEIGHTS.with_suffix(".json").read_text()))
    assert meta["steps"] == 3 and meta["n_train"] == 64
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == json.dumps(meta)
    assert sum(ln.startswith("step ") for ln in lines) == 2  # steps 0 and 2


def test_main_asks_for_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(["--n-train", "8", "--out", str(tmp_path / "x.npz")])
    assert not (tmp_path / "x.npz").exists()
