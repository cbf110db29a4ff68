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


def _perturbed(tree, seed):
    """Norm γ (around 1) and β, and biases, drawn: a misplaced norm or
    affine shows in the step."""
    r = np.random.default_rng(seed)

    def leaf(path, p):
        key = getattr(path[-1], "key", None)
        if key in ("bias", "beta"):
            return (r.normal(size=np.shape(p)) * 0.1).astype(np.float32)
        if key == "gamma":
            return r.normal(1.0, 0.3, np.shape(p)).astype(np.float32)
        return np.asarray(p)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def write_options(path, options, shape, raw_side):
    """For each spatial-step option (``{tag: config overrides}``, the tag
    ``uint8`` a uint8 batch): a JAX TrainState (norm γ, β and biases
    perturbed) carried into the port with a global batch, t and ε, saved to
    ``path``; JAX's injected step on them with the height split over a
    2-way ``spatial`` mesh and over a 2 × 2 ``data`` × ``spatial`` mesh
    (GSPMD, as ``make_spatial_train_step`` and ``make_dp_spatial_train_step``
    run it). The uint8 batch (``raw_side``² images) is cropped and flipped
    by the port's ``apply_augment`` on the draws of
    ``torch.Generator().manual_seed(3)`` (held against JAX's crop in
    test_torch_device_augment.py), and JAX's step takes the float batch.
    Returns {tag: {"spatial" | "dp": (loss, params as numpy)}}."""
    from gan_class_transfer2_tpu_torch.data import device_augment

    b, size = shape[0], shape[1]
    devices = np.asarray(jax.devices()[:4])
    meshes = {"spatial": (Mesh(devices[:2], ("spatial",)), P(None, "spatial"), P()),
              "dp": (Mesh(devices.reshape(2, 2), ("data", "spatial")), P("data", "spatial"),
                     P("data"))}
    saved, refs = {}, {}
    for k, (tag, over) in enumerate(options.items()):
        r = np.random.default_rng(50 + k)
        jcfg = jconfig.tiny_test_config(**{
            **dict(size=size, pixel_size=4, max_size=8, octaves=2, batch_size=b,
                   learning_rate=1e-2, warm_up=1, optimizer="momentum"), **over})
        st = jtrainer.init_state(jcfg, jax.random.PRNGKey(1))
        st = jax.tree_util.tree_map(np.asarray, st._replace(params=_perturbed(st.params, k)))
        raw = None
        if tag == "uint8":
            raw = torch.from_numpy(r.integers(0, 256, (b, raw_side, raw_side, 3), dtype=np.uint8))
            offsets, flips = device_augment.draw_augment(b, raw_side, raw_side, size,
                                                         torch.Generator().manual_seed(3))
            x = device_augment.apply_augment(raw, offsets, flips, size).numpy()
        else:
            x = r.uniform(-1, 1, shape).astype(np.float32)
        t = r.integers(1, jcfg.steps + 1, b).astype(np.int32)
        eps = r.normal(size=shape).astype(np.float32)
        step = jtrainer.make_injected_train_step(jcfg)
        refs[tag] = {}
        for kind, (mesh, spec_x, spec_t) in meshes.items():
            on = jax.device_put(jax.tree_util.tree_map(jnp.asarray, st), NamedSharding(mesh, P()))
            new, loss = step(on, jax.device_put(x, NamedSharding(mesh, spec_x)),
                             jax.device_put(t, NamedSharding(mesh, spec_t)),
                             jax.device_put(eps, NamedSharding(mesh, spec_x)))
            refs[tag][kind] = (float(loss), jax.tree_util.tree_map(np.asarray, new.params))
        cfg = Config.from_json(jcfg.to_json())
        saved[tag] = {"config": cfg.to_json(),
                      "state": weights.from_jax_train_state(cfg, st, device="cpu"),
                      "x": torch.from_numpy(x), "t": torch.from_numpy(t),
                      "eps": torch.from_numpy(eps), "raw": raw}
    torch.save(saved, path)
    return refs
