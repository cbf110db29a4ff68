"""JAX references for the port's tensor-parallel and spatial tests
(tests/test_torch_tp.py, tests/test_torch_spatial.py). Not a test module.

``write_injected`` carries a JAX TrainState, moved off its init by one JAX
injected step, into the port with a global batch, t and ε, and returns
JAX's injected step on them three ways: in one process, on a
``data=1, model=2`` mesh (the state under JAX's tensor-parallel
shardings) and with the batch's height split over a 2-way ``spatial``
mesh (GSPMD inserting the halos, as ``make_spatial_train_step`` runs)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gan_class_transfer2_tpu import config as jconfig
from gan_class_transfer2_tpu.parallel import mesh as jmesh
from gan_class_transfer2_tpu.train import trainer as jtrainer
from gan_class_transfer2_tpu_torch.config import Config
from gan_class_transfer2_tpu_torch.utils import weights

GLOBAL = 4


def write_injected(path, optimizer="adam_fused"):
    """Save the carried state and draws to ``path``; returns {"one",
    "tp", "spatial": (loss, params as numpy)} of JAX's injected step."""
    jcfg = jconfig.tiny_test_config(batch_size=GLOBAL, learning_rate=1e-3, warm_up=1,
                                    optimizer=optimizer)
    r = np.random.default_rng(21)
    st = jtrainer.init_state(jcfg, jax.random.PRNGKey(1))
    step = jtrainer.make_injected_train_step(jcfg)
    x0 = r.uniform(-1, 1, (GLOBAL, 16, 16, 3)).astype(np.float32)
    st, _ = step(st, jnp.asarray(x0), np.array([1, 4, 7, 9], np.int32),
                 jnp.asarray(r.normal(size=x0.shape).astype(np.float32)))
    jst = jax.tree_util.tree_map(np.asarray, st)
    x = r.uniform(-1, 1, x0.shape).astype(np.float32)
    t = np.array([2, 9, 5, 3], np.int32)
    eps = r.normal(size=x.shape).astype(np.float32)
    refs = {}
    new, loss = step(jax.tree_util.tree_map(jnp.asarray, jst), jnp.asarray(x), t, jnp.asarray(eps))
    refs["one"] = (float(loss), jax.tree_util.tree_map(np.asarray, new.params))
    tp = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    on = jax.device_put(jax.tree_util.tree_map(jnp.asarray, jst), jmesh.state_shardings(jst, tp))
    new, loss = step(on, jax.device_put(x, jmesh.batch_sharding(tp)), t, jnp.asarray(eps))
    refs["tp"] = (float(loss), jax.tree_util.tree_map(np.asarray, new.params))
    sp = Mesh(np.asarray(jax.devices()[:2]), ("spatial",))
    height = NamedSharding(sp, P(None, "spatial"))
    new, loss = step(jax.device_put(jax.tree_util.tree_map(jnp.asarray, jst),
                                    NamedSharding(sp, P())),
                     jax.device_put(x, height), t, jax.device_put(eps, height))
    refs["spatial"] = (float(loss), jax.tree_util.tree_map(np.asarray, new.params))
    cfg = Config.from_json(jcfg.to_json())
    torch.save({"config": cfg.to_json(),
                "state": weights.from_jax_train_state(cfg, jst, device="cpu"),
                "x": torch.from_numpy(x), "t": torch.from_numpy(t), "eps": torch.from_numpy(eps)},
               path)
    return refs


def port_params(jparams, cfg=None):
    """JAX params as the port's parameter list (``parameters()`` order)."""
    from gan_class_transfer2_tpu_torch.config import tiny_test_config

    model = weights.from_jax_params(cfg or tiny_test_config(), jparams, device="cpu")
    return [p.detach() for p in model.parameters()]
