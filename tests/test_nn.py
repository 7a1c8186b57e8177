"""The pytree-dataclass helper and the plain-JAX layers.

Parity tests feed the same parameter tree to each plain-JAX layer and to the
flax module it replaces (``tests/flax_reference.py``) and compare outputs
and gradients; they skip where flax is not installed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pdecontrol_tpu.models import blocks as B
from pdecontrol_tpu.models import factories
from pdecontrol_tpu.models import transition as Tr
from pdecontrol_tpu.sac import nets
from pdecontrol_tpu.utils.pytree import PyTreeNode, field

TOL = dict(rtol=1e-5, atol=1e-6)
FACTORIES = sorted(factories.REGISTRY)


# ------------------------------------------------------------------ pytree
class _Node(PyTreeNode):
    x: jax.Array
    n: int = field(static=True, default=3)


class _Sub(_Node):
    y: jax.Array = None


def test_pytree_node_fields_replace_and_frozen():
    node = _Node(jnp.ones(2), n=5)
    leaves, treedef = jax.tree.flatten(node)
    assert len(leaves) == 1 and "5" in str(treedef)
    back = jax.tree.unflatten(treedef, [jnp.zeros(2)])
    assert back.n == 5 and float(back.x.sum()) == 0.0
    new = node.replace(n=7)
    assert new.n == 7 and node.n == 5 and new.x is node.x
    with pytest.raises(dataclasses.FrozenInstanceError):
        node.n = 1


def test_pytree_node_subclass_adds_fields():
    sub = _Sub(jnp.ones(2), n=2, y=jnp.zeros(3))
    assert [leaf.shape for leaf in jax.tree.leaves(sub)] == [(2,), (3,)]
    assert jax.tree.map(lambda a: a + 1, sub).n == 2


def test_pytree_node_static_field_retraces_under_jit():
    traces = []

    @jax.jit
    def f(node):
        traces.append(node.n)
        return node.x * node.n

    f(_Node(jnp.ones(2), n=2))
    f(_Node(jnp.zeros(2), n=2))
    assert traces == [2]
    np.testing.assert_array_equal(f(_Node(jnp.ones(2), n=3)), [3.0, 3.0])
    assert traces == [2, 3]


# ------------------------------------------------------------ initialisers
def test_default_initialisers():
    key = jax.random.PRNGKey(0)
    x = jnp.ones((4, 64, 32))
    params = B.ConvBlock(features=256, kernel_size=3).init(key, x)["params"]
    kernel, bias = params["Conv_0"]["kernel"], params["Conv_0"]["bias"]
    assert kernel.shape == (3, 32, 256)
    np.testing.assert_array_equal(bias, 0.0)
    # lecun normal: std 1/sqrt(fan_in), fan_in = k * in_channels.
    assert abs(float(kernel.std()) * np.sqrt(3 * 32) - 1.0) < 0.05

    cell = Tr.CNNLSTMCell(schannels=4, ssize=8)
    carry = cell.init_carry(2)
    x = jnp.ones((2, 4, 8))
    cp = cell.init(key, carry, x, x, jnp.zeros((2,), bool))["params"]
    np.testing.assert_array_equal(cp["wx"]["bias"], [0.0] * 12 + [1.0] * 4)
    assert "bias" not in cp["wh"]

    qp = nets.QNetwork(hidden=64).init(key, jnp.ones((2, 1, 64)),
                                       jnp.ones((2, 1, 4)))["params"]
    limit = np.sqrt(6.0 / (68 + 64))  # xavier uniform
    k = np.asarray(qp["linear1"]["kernel"])
    assert np.abs(k).max() <= limit and np.abs(k).max() > 0.9 * limit


def test_init_is_deterministic_and_key_dependent():
    model = factories.make("KSAutoRegConvolutionalLSTM", delta=0.25, N=32)
    s, a = jnp.ones((2, 3, 1, 32)), jnp.ones((2, 5, 1, 32))
    p0 = model.init(jax.random.PRNGKey(0), s, a)
    p0b = model.init(jax.random.PRNGKey(0), s, a)
    p1 = model.init(jax.random.PRNGKey(1), s, a)
    same = jax.tree.map(lambda x, y: bool(jnp.all(x == y)), p0, p0b)
    assert all(jax.tree.leaves(same))
    k0 = p0["params"]["cell"]["wx"]["kernel"]
    assert not bool(jnp.all(k0 == p1["params"]["cell"]["wx"]["kernel"]))
    # Two sibling layers of one model get different draws.
    enc = p0["params"]["state_encoder"]
    assert not np.allclose(enc["block_l1"]["conv_l1"]["kernel"][:, :8],
                           enc["block_l2"]["conv_l1"]["kernel"][:, :8])


# ------------------------------------------------------------------ parity
@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("flax")
    from tests import flax_reference

    return flax_reference


def _assert_tree_close(a, b, **tol):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **tol)


def _same_layout(new_params, flax_params):
    shapes = lambda t: jax.tree.map(lambda x: x.shape, t)
    assert shapes(new_params) == shapes(jax.tree.map(jnp.asarray,
                                                     dict(flax_params)))


_LAYERS = {
    "SpatialLayerNorm": lambda m: m.SpatialLayerNorm(),
    "ConvBlock": lambda m: m.ConvBlock(features=6, kernel_size=5,
                                       layernorm=True),
    "DeConvBlock": lambda m: m.DeConvBlock(features=3, layernorm=True),
    "ResidualBlock": lambda m: m.ResidualBlock(features=8, layernorm=True),
    "LinearBlock": lambda m: m.LinearBlock(2, 8, jnp.tanh),
}


@pytest.mark.parametrize("name", sorted(_LAYERS))
def test_block_parity_with_flax(ref, name):
    x = jax.random.normal(jax.random.PRNGKey(1), (3, 16, 4), jnp.float32)
    old, new = _LAYERS[name](ref), _LAYERS[name](B)
    params = old.init(jax.random.PRNGKey(0), x)
    _same_layout(new.init(jax.random.PRNGKey(0), x)["params"],
                 params["params"])
    np.testing.assert_allclose(np.asarray(new.apply(params, x)),
                               np.asarray(old.apply(params, x)), **TOL)


_CELLS = {  # (cells module, blocks module) -> cell
    "LSTMCell": (lambda m, b: m.LSTMCell(schannels=1, ssize=8), (1, 8),
                 (1, 8)),
    "CNNLSTMCell": (lambda m, b: m.CNNLSTMCell(schannels=4, ssize=8),
                    (4, 8), (4, 8)),
    "CNNLSTMCell_unfused": (
        lambda m, b: m.CNNLSTMCell(schannels=4, ssize=8, fused=False),
        (4, 8), (4, 8)),
    "DelayCell": (
        lambda m, b: m.DelayCell(
            schannels=2, ssize=4, achannels=1, asize=4, delay=3,
            fwd=b.MLP(sizes=[(4, 4), (2, 4)],
                      activations=[jax.nn.elu, jnp.tanh])),
        (2, 4), (1, 4)),
}


@pytest.mark.parametrize("name", sorted(_CELLS))
def test_cell_parity_with_flax(ref, name):
    make, sshape, ashape = _CELLS[name]
    old, new = make(ref, ref), make(Tr, B)
    b = 3
    ks = jax.random.split(jax.random.PRNGKey(2), 3)
    carry = old.init_carry(b)
    carry = jax.tree.map(lambda z, k: jax.random.normal(k, z.shape), carry,
                         tuple(jax.random.split(ks[0], len(carry))))
    laction = jax.random.normal(ks[1], (b,) + ashape)
    lstate = jax.random.normal(ks[2], (b,) + sshape)
    tf = jnp.array([True, False, True])
    params = old.init(jax.random.PRNGKey(0), carry, laction, lstate, tf)
    _same_layout(new.init(jax.random.PRNGKey(0), carry, laction, lstate,
                          tf)["params"], params["params"])
    _assert_tree_close(new.apply(params, carry, laction, lstate, tf),
                       old.apply(params, carry, laction, lstate, tf), **TOL)


_FLAX_FACTORIES = {
    "KSAutoRegConvolutionalLSTM": "ks_autoreg_conv_lstm",
    "KSAutoRegFullyConnectedLSTM": "ks_autoreg_fc_lstm",
    "KSDelayCNNSurrogateFactory": "ks_delay_cnn",
    "KSLatentConvolutionalLSTM": "ks_latent_conv_lstm",
    "KSLatentLSTM": "ks_latent_lstm",
}


@pytest.mark.parametrize("name", FACTORIES)
def test_surrogate_parity_with_flax(ref, name):
    """Every factory: same tree layout, same teacher-forced + free-run +
    self-forced rollout from the same parameters."""
    old = getattr(ref, _FLAX_FACTORIES[name])(delta=0.25, N=32)
    new = factories.make(name, delta=0.25, N=32)
    ks = jax.random.split(jax.random.PRNGKey(3), 2)
    states = jax.random.normal(ks[0], (2, 3, 1, 32), jnp.float32)
    actions = jax.random.uniform(ks[1], (2, 6, 1, 32), jnp.float32, -1, 1)
    params = old.init(jax.random.PRNGKey(0), states, actions)
    _same_layout(new.init(jax.random.PRNGKey(0), states, actions)["params"],
                 params["params"])
    reencode = np.array([False, False, False, True, False, True])
    for kw in ({}, {"reencode": reencode}):
        _assert_tree_close(new.apply(params, states, actions, **kw),
                           old.apply(params, states, actions, **kw), **TOL)


def test_flagship_surrogate_gradient_parity(ref):
    """The flagship conv-LSTM at full width (N = 64): same loss and same
    parameter gradients through the scanned rollout."""
    old = ref.ks_autoreg_conv_lstm(delta=0.25, N=64)
    new = factories.make("KSAutoRegConvolutionalLSTM", delta=0.25, N=64)
    ks = jax.random.split(jax.random.PRNGKey(4), 3)
    states = jax.random.normal(ks[0], (4, 5, 1, 64), jnp.float32)
    actions = jax.random.uniform(ks[1], (4, 10, 1, 64), jnp.float32, -1, 1)
    target = jax.random.normal(ks[2], (4, 10, 1, 64), jnp.float32)
    params = old.init(jax.random.PRNGKey(0), states, actions)["params"]

    def loss(model):
        def f(p):
            roll = model.apply({"params": p}, states, actions,
                               reencode=np.arange(10) % 4 == 3)
            return jnp.mean((roll.outputs - target) ** 2)
        return jax.value_and_grad(f)(params)

    (l_new, g_new), (l_old, g_old) = loss(new), loss(old)
    np.testing.assert_allclose(float(l_new), float(l_old), rtol=1e-6)
    _assert_tree_close(g_new, g_old, rtol=1e-4, atol=1e-7)


def test_sac_nets_parity_with_flax(ref):
    obs = jax.random.normal(jax.random.PRNGKey(5), (8, 1, 64), jnp.float32)
    act = jax.random.uniform(jax.random.PRNGKey(6), (8, 1, 4), jnp.float32)
    key = jax.random.PRNGKey(7)
    old_pi = ref.GaussianPolicy(achannels=1, asize=4, hidden=32)
    new_pi = nets.GaussianPolicy(achannels=1, asize=4, hidden=32)
    pp = old_pi.init(jax.random.PRNGKey(0), obs)
    _same_layout(new_pi.init(jax.random.PRNGKey(0), obs)["params"],
                 pp["params"])
    _assert_tree_close(new_pi.apply(pp, obs), old_pi.apply(pp, obs), **TOL)
    _assert_tree_close(
        new_pi.apply(pp, obs, key, method=nets.GaussianPolicy.sample),
        old_pi.apply(pp, obs, key, method=ref.GaussianPolicy.sample), **TOL)

    old_q, new_q = ref.QNetwork(hidden=32), nets.QNetwork(hidden=32)
    qp = old_q.init(jax.random.PRNGKey(1), obs, act)
    _same_layout(new_q.init(jax.random.PRNGKey(1), obs, act)["params"],
                 qp["params"])
    _assert_tree_close(new_q.apply(qp, obs, act), old_q.apply(qp, obs, act),
                       **TOL)
