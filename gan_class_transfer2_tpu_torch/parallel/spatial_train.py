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
  * a uint8 batch is the rank's rows of the global batch, whole images
    (``HBMDataset`` under a spatial mesh gives every spatial rank of a data
    group the same rows): the step crops, flips and normalises them with
    the global batch's draws (``data/device_augment``), as the one-process
    step does, then takes the rank's block of rows;
  * the loss is the global mean. ``mse`` and ``l1``: the rank's sum over
    the global count, summed over the ranks. ``dct`` and ``mse_multiscale``
    transform whole images, so the prediction and the target are gathered
    over ``spatial`` (``spatial.gather_height``, whose adjoint keeps the
    rank's rows) and every rank of a data group takes the one-process loss
    of its rows' whole images over the data extent; the parameters'
    gradients are then the one-process ones once summed over every rank;
  * the parameters are whole on every rank, so their gradients are summed
    over every rank by one ``all_reduce`` before the optimizer's update,
    which each rank then applies alike (``trainer.finish_step``: the
    summed gradients are the same on every rank, so dynamic loss
    scaling's non-finite gate skips or applies on every rank alike; B2 is
    gated off at more than one rank, as in JAX);
  * the body (``spatial_unet.make_local_apply``) takes ``g_norm`` (B3 over
    height blocks, batch norm over data × spatial) and ``per_step_output``.

The ranks are laid out as JAX's ``reshape(data, spatial)``, the spatial
axis fastest. Only a conditional model is refused, by JAX's message.
"""

from __future__ import annotations

import torch

from ..core import diffusion
from ..data import device_augment
from ..ops import fused_diffusion
from ..train import trainer
from . import multihost
from .mesh import Grid, Sharding, grid_groups
from .spatial import gather_height
from .spatial_unet import make_local_apply


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
    cfg.refuse_published_cyclegan("spatial")


def _local_loss(cfg, target, prediction, count: int, mesh):
    """``(for the gradient, for the sum)``: the rank's share of the global
    mean loss. ``mse``/``l1``: its sum over ``count``, both. The whole-image
    losses: the one-process loss of its data rows' whole images over the
    data extent, for the gradient (summed over the spatial ranks each row
    block's gradient counts once), and that over the spatial extent too
    for the loss's sum over every rank."""
    if cfg.loss in ("mse", "l1"):
        d = target.to(torch.float32) - prediction.to(torch.float32)
        if cfg.loss == "mse":
            share = torch.sum(torch.square(d)) / count
        else:
            share = torch.sum(torch.maximum(d, -d)) / count  # l1 (train.py:267-270)
        return share, share
    sp = mesh.axis("spatial")
    whole = trainer.compute_loss(cfg, gather_height(target.to(torch.float32), sp),
                                 gather_height(prediction.to(torch.float32), sp))
    share = whole / mesh.axis("data").size
    return share, share / sp.size


def _make_sharded_train_step(cfg, mesh: SpatialMesh, batch_sh: Sharding):
    """``step(state, batch, generator, *, t_int=None, epsilon=None) ->
    (state, loss)`` over the mesh: ``batch`` the rank's block, ``t_int``
    and ``epsilon`` (both or neither) the rank's rows of t and block of ε
    when injected. One builder for the spatial and DP × spatial steps:
    they differ only in the batch spec (spatial_train.py:59)."""
    _check(cfg)
    apply = make_local_apply(cfg, mesh)
    optimizer = trainer.make_optimizer(cfg)
    # the state is whole on every rank (JAX replicates it): no ZeRO-1 slices;
    # the mesh's size gates B2 off
    whole = cfg.replace(zero1=False)
    spec = batch_sh.spec
    extents = {"data": mesh.axis("data").size, "spatial": mesh.axis("spatial").size}
    # the linear position over the batch spec's axes (kernels.py:247-259)
    position = (mesh.coords["data"] * extents["spatial"] if spec[0] == "data" else 0) + (
        mesh.coords["spatial"])

    def step(state, batch, generator, *, t_int=None, epsilon=None):
        if batch.dtype == torch.uint8:  # the rank's rows, whole: augment, then its block
            s = mesh.axis("spatial")
            batch = device_augment.augment_batch(batch, generator, cfg.size, mesh)
            h = batch.shape[1] // s.size
            batch = batch[:, s.index * h:(s.index + 1) * h]
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
        scale = trainer.loss_scale(cfg, state)
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
            pred = apply(model, noised, t_int[:, 0, 0, 0]).to(torch.float32) * pred_scale
            loss, share = _local_loss(cfg, target, pred, count, mesh)
            if scale is not None:
                loss, share = loss * scale, share * scale
            grads = torch.autograd.grad(loss, params)
        summed = multihost.all_reduce_mean([*grads, share.detach()], None, mean=False)
        return trainer.finish_step(whole, optimizer, state, params, summed[:-1], summed[-1],
                                   scale, mesh)

    return step


def make_dp_spatial_train_step(cfg, mesh: SpatialMesh):
    """The train step over a ``data`` × ``spatial`` mesh: the batch over
    ``data``, every activation's height over ``spatial``, parameters
    whole (spatial_train.py:97)."""
    return _make_sharded_train_step(cfg, mesh, dp_spatial_batch_sharding(mesh))


def make_spatial_train_step(cfg, mesh: SpatialMesh):
    """The train step with height-sharded activations (spatial_train.py:105)."""
    return _make_sharded_train_step(cfg, mesh, spatial_batch_sharding(mesh))
