"""tpulmi_torch.models against tpulmi.models: converted weights, Adam
training from the same start, and the training plan."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpulmi.models import mlp as jmlp
from tpulmi.models import train as jtrain
from tpulmi_torch.convert import mlp_from_flax, mlp_state_from_flax
from tpulmi_torch.models import mlp as tmlp
from tpulmi_torch.models import train as ttrain

torch.set_num_threads(1)


def _flax_params(model_type, d, n_classes, seed=0):
    model = jmlp.make_model(model_type, n_classes)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, d), jnp.float32))["params"]
    return model, params


@pytest.mark.parametrize("model_type", sorted(tmlp.MODEL_HIDDEN_DIMS))
def test_converted_logits_match(rng, model_type):
    assert tmlp.MODEL_HIDDEN_DIMS == jmlp.MODEL_HIDDEN_DIMS
    model, params = _flax_params(model_type, 24, 13)
    x = rng.normal(size=(50, 24)).astype(np.float32)
    want = np.asarray(model.apply({"params": params}, x))
    tm = mlp_from_flax(jax.device_get(params))
    assert tm.hidden_dims == tmlp.MODEL_HIDDEN_DIMS[model_type]
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)


def _adam_problem(rng, d=16, n_classes=7, n=400):
    model, params = _flax_params("MLP-5", d, n_classes, seed=3)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    idx = rng.integers(0, n, size=(20, 32)).astype(np.int64)

    def loss_fn(p, xb, yb):   # the JAX package's loss (models/train.py)
        logits = model.apply({"params": p}, xb)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, yb).mean()

    return params, X, y, idx, jax.jit(jax.value_and_grad(loss_fn))


def test_adam_steps_match_optax(rng):
    """20 steps from the same weights on the same batches: the port's
    torch.optim.Adam against optax.adam with the JAX package's loss.

    lr is 1e-3: Adam divides each gradient by its own running magnitude, so
    where a gradient is near float32 round-off the two frameworks' sums
    (taken in another order) step in different directions, and the drift
    grows with lr (up to ~1e-3 after 20 steps at lr 3e-3 for some seeds).
    The update rule itself is held at the build's lr, on shared gradients,
    by test_adam_update_matches_optax."""
    lr = 0.001
    params, X, y, idx, step = _adam_problem(rng)
    params0 = params
    tx = optax.adam(lr)
    opt_state = tx.init(params)
    j_losses = []
    for b in idx:
        loss, grads = step(params, X[b], y[b])
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        j_losses.append(float(loss))

    tm = mlp_from_flax(jax.device_get(params0))
    losses = ttrain.run_epochs(tm, ttrain.make_optimizer(tm, lr),
                               torch.from_numpy(X), torch.from_numpy(y),
                               [torch.from_numpy(idx)])
    np.testing.assert_allclose(float(losses[0]), np.mean(j_losses),
                               atol=1e-5)
    want = mlp_state_from_flax(jax.device_get(params))
    for name, value in tm.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)


def test_adam_update_matches_optax(rng):
    """torch.optim.Adam (make_optimizer) and optax.adam at the build's lr,
    fed the same gradients for 20 steps, give the same parameters."""
    lr = 0.003
    params, X, y, idx, step = _adam_problem(rng)
    tm = mlp_from_flax(jax.device_get(params))
    opt = ttrain.make_optimizer(tm, lr)
    tx = optax.adam(lr)
    opt_state = tx.init(params)
    for b in idx:
        _, grads = step(params, X[b], y[b])
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        torch_grads = mlp_state_from_flax(jax.device_get(grads))
        for name, p in tm.named_parameters():
            p.grad = torch_grads[name]
        opt.step()
    want = mlp_state_from_flax(jax.device_get(params))
    for name, value in tm.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("ref", [False, True])
def test_train_plan_identical(ref):
    for n in (1, 100, 1023, 1024, 5000, 300_000):
        for epochs in (1, 12, 205):
            for batch in (256, 1024):
                for cap in (None, 0, 50, 20_000):
                    assert ttrain.train_plan(n, epochs, batch, cap, ref) == \
                        jtrain.train_plan(n, epochs, batch, cap, ref)


def test_init_matches_flax_distribution():
    """Truncated lecun-normal kernels, zero biases: the same distribution as
    flax's nn.Dense init (the bits differ)."""
    _, params = _flax_params("MLP-3", 400, 300)
    tm = tmlp.make_model("MLP-3", 400, 300,
                         generator=torch.Generator().manual_seed(0))
    for i, layer in enumerate(tm.layers):
        w = layer.weight.detach().numpy()
        fw = np.asarray(params[f"Dense_{i}"]["kernel"])
        assert abs(w.std() - fw.std()) < 0.03 * fw.std()
        bound = 2 * np.sqrt(1.0 / layer.in_features) / tmlp._TRUNC_STD
        assert np.abs(w).max() <= bound + 1e-6
        assert (layer.bias.detach().numpy() == 0).all()


def test_classifier_train_predict(rng):
    X = rng.normal(size=(600, 8)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.int64) + 2 * (X[:, 1] > 0)
    clf = ttrain.BucketClassifier(8, 4, lr=0.01, model_type="MLP-2",
                                  device="cpu")
    losses = clf.train(X, y, epochs=30, batch_size=64)
    assert losses.shape == (30,) and float(losses[-1]) < float(losses[0])
    pred = clf.predict(X, chunk=100)
    assert pred.dtype == torch.int32 and (pred.numpy() == y).mean() > 0.9
    probs, top = clf.predict_proba(X[:5], top=2)
    assert probs.shape == top.shape == (5, 2)
    assert (probs[:, 0] >= probs[:, 1]).all()
