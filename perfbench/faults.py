"""Faults planted in the program under test, to show that the comparison
fails them: each is a context manager that patches one function of the
port for its duration. Used by ``calibrate.py`` (on the card, at a cell's
size) and by ``tests/test_perfbench_faults.py`` (on the CPU), never by a
run of ``run.py``.

  * ``unchanged``: a step that returns its state unchanged (training: no
    update applied; sampling: a denoiser step that leaves x̂ and ε̂ as they
    were);
  * ``half_batch``: half of the batch left out, the mean taken over the rest
    (training);
  * ``altered``: an answer altered where it is produced (sampling: the
    first image of a call replaced by the second);
  * ``no_exchange``: the exchange between the cards left out (data
    parallelism: each rank updates with its own rows' gradient).
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def unchanged(kind):
    if kind in ("train", "train_dp"):
        from gan_class_transfer2_tpu_torch.train import trainer

        def make(orig):
            def finish_step(cfg, optimizer, state, params, grads, loss, scale, mesh=None):
                return state._replace(step=state.step + 1), loss
            return finish_step

        with _patched(trainer, "finish_step", make):
            yield
    elif kind == "gan_train":
        from gan_class_transfer2_tpu_torch.train import gan

        def make(orig):
            def update_both(cfg, g_optimizer, d_optimizer, state, gp, dp, g_grads, d_grads,
                            metrics, mesh=None):
                return state.g_opt, state.d_opt, metrics
            return update_both

        with _patched(gan, "_update_both", make):
            yield
    elif kind == "sample":
        from gan_class_transfer2_tpu_torch.sample import sampler

        def make(orig):
            def step(cfg, model, x_theta, epsilon_theta, t, class_idx=None):
                return x_theta, epsilon_theta
            return step

        with _patched(sampler, "step", make):
            yield
    else:
        raise ValueError(f"no 'unchanged' fault for traffic {kind!r}")


@contextlib.contextmanager
def half_batch(kind):
    if kind in ("train", "train_dp"):
        from gan_class_transfer2_tpu_torch.train import trainer

        def make(orig):
            def compute_loss(cfg, target, prediction):
                h = target.shape[0] // 2
                return orig(cfg, target[:h], prediction[:h])
            return compute_loss

        with _patched(trainer, "compute_loss", make):
            yield
    elif kind == "gan_train":
        from gan_class_transfer2_tpu_torch.train import gan

        def make_l1(orig):
            def l1(a, b):
                h = a.shape[0] // 2
                return orig(a[:h], b[:h])
            return l1

        def make_adv(orig):
            def adversarial_loss(cfg, logits, is_real, for_generator):
                return orig(cfg, logits[:logits.shape[0] // 2], is_real, for_generator)
            return adversarial_loss

        with _patched(gan, "_l1", make_l1), _patched(gan, "adversarial_loss", make_adv):
            yield
    else:
        raise ValueError(f"no 'half_batch' fault for traffic {kind!r}")


@contextlib.contextmanager
def altered(kind):
    if kind != "sample":
        raise ValueError(f"no 'altered' fault for traffic {kind!r}")
    from gan_class_transfer2_tpu_torch.sample import sampler

    def make(orig):
        def sample(*args, **kwargs):
            res = orig(*args, **kwargs)
            images = res.images.clone()
            images[0] = images[1]
            return res._replace(images=images)
        return sample

    with _patched(sampler, "sample", make):
        yield


@contextlib.contextmanager
def no_exchange(kind):
    if kind != "train_dp":
        raise ValueError(f"no 'no_exchange' fault for traffic {kind!r}")
    from gan_class_transfer2_tpu_torch.train import trainer

    def make(orig):
        def average_over_ranks(mesh, grads, metrics):
            return list(grads), metrics
        return average_over_ranks

    with _patched(trainer, "average_over_ranks", make):
        yield


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered,
          "no_exchange": no_exchange}
KINDS = {"train": ("unchanged", "half_batch"), "gan_train": ("unchanged", "half_batch"),
         "sample": ("unchanged", "altered"),
         "train_dp": ("unchanged", "half_batch", "no_exchange")}
