"""Shared set-up for the port's parity tests: seeded JAX FCDenseNet
variables with non-trivial BatchNorm statistics and conv biases, and the
same weights in the port."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from endoscopydepthestimation_pytorch_tpu import training
from endoscopydepthestimation_pytorch_tpu_torch.models import from_jax_variables

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def seeded_jax_state(model, input_shape, seed):
    """A JAX TrainState for ``model`` (jitted init) whose BN scale/bias,
    running mean/var and conv biases are replaced by seeded numpy draws."""
    state = training.create_train_state(model, jax.random.PRNGKey(seed),
                                        input_shape, training.TrainConfig())
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        names = [getattr(p, "key", str(p)) for p in path]
        leaf = np.asarray(leaf)
        if names[-2:] == ["norm", "scale"]:
            return (rng.rand(*leaf.shape) + 0.5).astype(np.float32)
        if names[-1] == "bias":
            return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)
        if names[-1] == "mean":
            return (rng.randn(*leaf.shape) * 0.2).astype(np.float32)
        if names[-1] == "var":
            return (rng.rand(*leaf.shape) + 0.5).astype(np.float32)
        return leaf

    return state.replace(
        params=jax.tree_util.tree_map_with_path(draw, state.params),
        batch_stats=jax.tree_util.tree_map_with_path(draw, state.batch_stats))


def jax_numpy_variables(state):
    return (jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, state.batch_stats))


def port_state_dict(state, **arch):
    return from_jax_variables(*jax_numpy_variables(state), **arch)


def jax_predict(state, colors, boundaries):
    return np.asarray(jax.jit(training.predict_step)(
        state, jnp.asarray(colors), jnp.asarray(boundaries)))
