"""Faults planted under the localizer cell's timed path, for the readings
that set the limits of `correct` (control.py --faults) and for the CPU test
that sees `correct` come out false for each. The cell runs on one card,
so it has no exchange between chips to leave out."""

from __future__ import annotations

import contextlib


def _k1_state_unchanged(real):
    """K1 hands back its input state, and the input pose for every frame."""
    def k1(*a):
        out = list(real(*a))
        pose, odom_prev, ft, fc, fp = a[9], a[10], a[11], a[12], a[13]
        out[0] = pose.expand_as(out[0]).clone()
        out[4:9] = [pose, odom_prev, ft, fc, fp]
        return tuple(out)
    return k1


def _k1_half_batch(real):
    """Every other source point of every frame left out (moved to the
    sentinel): the ICP's means are taken over the rest."""
    def k1(*a):
        a = list(a)
        pages = a[0].clone()
        pages[..., 1::2] = 1.0e7
        a[0] = pages
        return real(*a)
    return k1


def _k1_answer_altered(real):
    """One frame's pose moved by 1 cm where K1 produces it."""
    def k1(*a):
        out = list(real(*a))
        out[0] = out[0].clone()
        out[0][3, 0, 3] += 0.01
        return tuple(out)
    return k1


def _startup_altered(real):
    """The start-up pose moved by 1 cm where the coarse attempt produces it."""
    def coarse(state, *a):
        cmap, cache, ref_T, cs, co = real(state, *a)
        T = co.map_T_sensor.clone()
        T[0, 3] += 0.01
        return cmap, cache, ref_T, cs, co._replace(map_T_sensor=T)
    return coarse


#: name -> (module attribute patched, wrapper)
FAULTS = {
    "state_unchanged": ("pipeline_fast.superblock_fine", _k1_state_unchanged),
    "half_batch": ("pipeline_fast.superblock_fine", _k1_half_batch),
    "answer_altered": ("pipeline_fast.superblock_fine", _k1_answer_altered),
    "startup_altered": ("localization.coarse_attempt", _startup_altered),
}


@contextlib.contextmanager
def planted(name: str):
    """The program with fault `name` in place for the block."""
    import importlib

    target, wrap = FAULTS[name]
    mod_name, attr = target.split(".")
    mod = importlib.import_module(f"slam_sensor_fusion_tpu_torch.models.{mod_name}")
    real = getattr(mod, attr)
    setattr(mod, attr, wrap(real))
    try:
        yield
    finally:
        setattr(mod, attr, real)
