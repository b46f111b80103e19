"""Faults planted under the timed path, for the tests that see ``correct``
come out false and for the calibration of the limits. Each takes the
driver after its build and before its first step; ``undo`` restores what
a fault patched outside the driver."""

from __future__ import annotations


def unchanged(driver) -> None:
    """Every training step returns the state as it found it."""
    driver.state.apply_gradients = lambda: None


def half_batch(driver) -> None:
    """Half of each batch left out, the loss the mean over the rest."""
    step_fn = driver.step_fn

    def halved(state, batch, draws):
        n = batch["source"].shape[0] // 2
        return step_fn(state, {k: v[:n] for k, v in batch.items()},
                       {k: (v[:n] if v.ndim else v) for k, v in draws.items()})

    driver.step_fn = halved


def no_exchange(driver) -> None:
    """The gradients' all-reduce between the ranks left out."""
    from medfusion_tpu_torch.parallel import mesh

    driver.saved_sync = mesh.sync_gradients
    mesh.sync_gradients = lambda model, group: None


def altered_answer(driver) -> None:
    """The first image of every chunk altered where the sampler returns it."""
    sampler = driver.sampler

    def altered(*args, **kwargs):
        images = sampler(*args, **kwargs)
        images[0] = -images[0]
        return images

    driver.sampler = altered


def undo(driver) -> None:
    saved = getattr(driver, "saved_sync", None)
    if saved is not None:
        from medfusion_tpu_torch.parallel import mesh

        mesh.sync_gradients = saved


FAULTS = {"unchanged": unchanged, "half": half_batch, "exchange": no_exchange,
          "answer": altered_answer}
