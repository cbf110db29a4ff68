"""Training with height-sharded activations — counterpart of
gan_class_transfer2_tpu/parallel/spatial_train.py.

JAX jits its unchanged train step with the batch's height sharded over a
``spatial`` mesh axis and lets XLA's partitioner insert the halos. The
port has no partitioner, so the step here is the trainer's step with the
U-Net forward replaced by the height-sharded body of ``spatial_unet``:

  * each rank holds its block of the global batch: rows over ``data`` (on
    a DP × spatial mesh) and image rows over ``spatial``;
  * t is drawn for the global batch, ε for the global (B, H, W, 3) batch,
    and the rank takes its block of each, so the step equals the
    one-process step on the same generator state. On the fused path each
    rank runs B1s on its block (``ops/fused_diffusion``) at its linear
    position over the batch spec's axes, JAX's fold (kernels.py:247-259):
    the spatial index under ``P(None, 'spatial')``, ``data·S + spatial``
    under ``P('data', 'spatial')``;
  * the loss is the global mean: the rank's sum over the global count,
    summed over the ranks; the parameters are whole on every rank, so
    their gradients are summed over every rank by one ``all_reduce``
    before the optimizer's update, which each rank then applies alike.

The ranks are laid out as JAX's ``reshape(data, spatial)``, the spatial
axis fastest. What the hand-written body cannot take is refused by name:
a conditional model (JAX's own refusal), ``per_step_output`` and
``g_norm`` (``spatial_unet``'s), the ``dct`` and ``mse_multiscale``
losses (their transforms span the height axis), dynamic loss scaling, and
uint8 batches (the on-device crop spans it too).
"""

from __future__ import annotations

import torch

from ..core import diffusion
from ..ops import fused_diffusion
from ..train import trainer
from . import multihost
from .mesh import Grid, Sharding, grid_groups
from .spatial_unet import make_spatial_unet_apply


class SpatialMesh(Grid):
    """The process group as a ``data`` × ``spatial`` grid (``data`` 1 for a
    spatial mesh), spatial fastest, rows over ``data``."""

    AXES = {"data": ("data",), "spatial": ("spatial",)}

    def __init__(self, data: int, spatial: int, rank: int, device, groups=None):
        super().__init__({"data": data, "spatial": spatial}, rank, device, ("data",), groups)
        self.shape = {"spatial": spatial} if data == 1 else {"data": data, "spatial": spatial}
        self.axis_names = tuple(self.shape)


def _make(data: int, spatial: int, device):
    from ..models.api import resolve_device

    dev = multihost.local_device(resolve_device(device))
    rank = multihost.process_index()
    groups = grid_groups({"data": data, "spatial": spatial}, rank, SpatialMesh.AXES)
    mesh = SpatialMesh(data, spatial, rank, dev, groups)
    multihost.set_axes({name: mesh.axis(name) for name in ("spatial", "data", "batch")})
    return mesh


def make_spatial_mesh(n: int | None = None, device="cuda") -> SpatialMesh:
    """The process group as ``n`` height shards (all of it by default;
    spatial_train.py:25)."""
    world = multihost.process_count()
    n = n or world
    if n > world:
        raise ValueError(f"spatial mesh needs {n} devices, have {world}")
    if n != world:
        raise ValueError(f"spatial mesh of {n} shards in a group of {world} processes: "
                         "the mesh must take the whole group")
    return _make(1, n, device)


def make_dp_spatial_mesh(data: int, spatial: int, device="cuda") -> SpatialMesh:
    """``data`` × ``spatial`` ranks: the batch over ``data``, the height over
    ``spatial`` (spatial_train.py:44)."""
    world = multihost.process_count()
    n = data * spatial
    if n > world:
        raise ValueError(f"mesh {data}x{spatial} needs {n} devices")
    if n != world:
        raise ValueError(f"mesh {data}x{spatial} in a group of {world} processes: the mesh "
                         "must take the whole group")
    return _make(data, spatial, device)


def spatial_batch_sharding(mesh: SpatialMesh) -> Sharding:
    """Batch whole, height sharded: (B, H/n, W, C) a rank."""
    return Sharding(mesh, (None, "spatial"))


def dp_spatial_batch_sharding(mesh: SpatialMesh) -> Sharding:
    """Batch over ``data``, height over ``spatial``."""
    return Sharding(mesh, ("data", "spatial"))


def local_rows(x, mesh: SpatialMesh):
    """This rank's rows over ``data`` of a global batch (t, a label)."""
    d = mesh.axis("data")
    b = x.shape[0] // d.size
    return x[d.index * b:(d.index + 1) * b]


def local_block(x, mesh: SpatialMesh):
    """This rank's block of a global (B, H, …) tensor: its rows over
    ``data`` and image rows over ``spatial``."""
    s = mesh.axis("spatial")
    h = x.shape[1] // s.size
    return local_rows(x, mesh)[:, s.index * h:(s.index + 1) * h]


def _check(cfg):
    if cfg.num_classes > 0:
        raise ValueError(
            "spatial training supports the unconditional Denoiser only "
            "(num_classes == 0)"
        )
    if cfg.loss not in ("mse", "l1"):
        raise NotImplementedError(
            f"loss={cfg.loss!r} is not supported by the spatial step: its transform "
            "spans the sharded height axis; use mse or l1")
    if cfg.dynamic_loss_scale:
        raise NotImplementedError("dynamic_loss_scale is not supported by the spatial step")


def _local_loss(cfg, target, prediction, count: int):
    """The rank's share of the global mean loss: its sum over ``count``."""
    d = target.to(torch.float32) - prediction.to(torch.float32)
    if cfg.loss == "mse":
        return torch.sum(torch.square(d)) / count
    return torch.sum(torch.maximum(d, -d)) / count  # l1 (train.py:267-270)


def _make_sharded_train_step(cfg, mesh: SpatialMesh, batch_sh: Sharding):
    """``step(state, batch, generator, *, t_int=None, epsilon=None) ->
    (state, loss)`` over the mesh: ``batch`` the rank's block, ``t_int``
    and ``epsilon`` (both or neither) the rank's rows of t and block of ε
    when injected. One builder for the spatial and DP × spatial steps:
    they differ only in the batch spec (spatial_train.py:59)."""
    _check(cfg)
    apply = make_spatial_unet_apply(cfg, mesh)
    optimizer = trainer.make_optimizer(cfg)
    spec = batch_sh.spec
    extents = {"data": mesh.axis("data").size, "spatial": mesh.axis("spatial").size}
    # the linear position over the batch spec's axes (kernels.py:247-259)
    position = (mesh.coords["data"] * extents["spatial"] if spec[0] == "data" else 0) + (
        mesh.coords["spatial"])

    def step(state, batch, generator, *, t_int=None, epsilon=None):
        if batch.dtype == torch.uint8:
            raise TypeError("the spatial step takes float batches: the on-device crop of a "
                            "uint8 batch spans the sharded height axis")
        batch = batch.contiguous()
        b, h, w, c = batch.shape
        big = (b * extents["data"], h * extents["spatial"], w, c)
        dev = batch.device
        if t_int is None:
            t_int = local_rows(torch.randint(
                1, cfg.steps + 1, (big[0], 1, 1, 1), generator=generator,
                device=generator.device, dtype=torch.int32), mesh)
        t_int = torch.as_tensor(t_int, dtype=torch.int32).reshape(b, 1, 1, 1).to(dev)
        fused = fused_diffusion.use_fused(cfg, batch.shape, epsilon) and (
            fused_diffusion.fused_sharded_ok(cfg, big, extents, spec))
        model = state.model
        params = list(model.parameters())
        scale = cfg.loss_scale if cfg.loss_scale > 0 else None
        with torch.no_grad():
            if fused:
                seed = torch.randint(0, 2**62, (1,), generator=generator,
                                     device=generator.device, dtype=torch.int64).to(dev)
                noised = fused_diffusion.forward_diffuse_fused_sharded(cfg, batch, t_int, seed,
                                                                       position)
                eps, t = None, None
            else:
                if epsilon is None:
                    epsilon = local_block(torch.randn(big, generator=generator,
                                                      device=generator.device,
                                                      dtype=batch.dtype), mesh)
                eps = torch.as_tensor(epsilon, dtype=batch.dtype).to(dev)
                t = t_int.to(batch.dtype)
                noised = diffusion.forward_diffuse(cfg, batch, eps, t)
            target, pred_scale = diffusion.training_target(cfg, batch, eps, t)
        count = big[0] * big[1] * big[2] * big[3]
        from ..models import unet

        with unet.ieee_fp32(torch.float32, dev):
            pred = apply(model, noised).to(torch.float32) * pred_scale
            loss = _local_loss(cfg, target, pred, count)
            if scale is not None:
                loss = loss * scale
            grads = torch.autograd.grad(loss, params)
        summed = multihost.all_reduce_mean([*grads, loss.detach()], None, mean=False)
        grads, loss = summed[:-1], summed[-1]
        if scale is not None:
            loss = loss / scale
            grads = [g / scale for g in grads]
        opt_state = trainer.update_params(optimizer, state.opt_state, params, grads)
        ema = trainer.ema_update(cfg, state.ema_params, params, opt_state)
        return trainer.TrainState(state.step + 1, model, opt_state, ema,
                                   state.scale_state), loss

    return step


def make_dp_spatial_train_step(cfg, mesh: SpatialMesh):
    """The train step over a ``data`` × ``spatial`` mesh: the batch over
    ``data``, every activation's height over ``spatial``, parameters
    whole (spatial_train.py:97)."""
    return _make_sharded_train_step(cfg, mesh, dp_spatial_batch_sharding(mesh))


def make_spatial_train_step(cfg, mesh: SpatialMesh):
    """The train step with height-sharded activations (spatial_train.py:105)."""
    return _make_sharded_train_step(cfg, mesh, spatial_batch_sharding(mesh))
