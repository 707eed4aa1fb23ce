"""The port's own configuration and learned BRIEF pattern equal the JAX
package's: every dataclass field by field, every preset, and the table."""

import dataclasses

import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.ops import orb_pattern as jpattern
from orbslam2_dualcam_tpu.utils import config as jconfig
from orbslam2_dualcam_tpu_torch.ops import orb_pattern as tpattern
from orbslam2_dualcam_tpu_torch.ops import orb_tables
from orbslam2_dualcam_tpu_torch.utils import config as tconfig
from orbslam2_dualcam_tpu_torch.utils.convert import config_from_reference

torch.set_num_threads(1)

_CLASSES = sorted(n for n, c in vars(jconfig).items()
                  if dataclasses.is_dataclass(c) and isinstance(c, type))
_PRESETS = sorted(n for n, f in vars(jconfig).items()
                  if callable(f) and not isinstance(f, type)
                  and getattr(f, "__module__", None) == jconfig.__name__)


def test_the_port_has_every_class_and_preset():
    assert len(_CLASSES) == 11 and _PRESETS == ["dual_default"]
    for name in _CLASSES + _PRESETS:
        assert hasattr(tconfig, name), name
        assert getattr(tconfig, name).__module__ == tconfig.__name__


@pytest.mark.parametrize("name", _CLASSES)
def test_dataclass_defaults_equal_the_reference(name):
    """Same field names in the same order, same defaults, same derived
    properties."""
    j, t = getattr(jconfig, name)(), getattr(tconfig, name)()
    assert ([f.name for f in dataclasses.fields(j)] ==
            [f.name for f in dataclasses.fields(t)])
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for prop in ("n_track", "n_init", "scale_factors", "level_sigma2",
                 "n_cameras"):
        if hasattr(j, prop):
            np.testing.assert_array_equal(getattr(j, prop), getattr(t, prop))
    assert hash(t) == hash(getattr(tconfig, name)())     # frozen, hashable


@pytest.mark.parametrize("name", _PRESETS)
def test_preset_equals_the_reference(name):
    j, t = getattr(jconfig, name)(), getattr(tconfig, name)()
    assert type(t) is tconfig.SystemConfig
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_config_from_reference_round_trips():
    """A non-default reference config converts to the port's classes with
    the same values, nested and in tuples, and back to the same dict."""
    j = jconfig.dual_default().replace(
        orb=jconfig.OrbConfig(n_levels=4, brief_learned=True, pallas_fast=False),
        ba=jconfig.BAConfig(pose_iters=7), fps=15.0)
    t = config_from_reference(j)
    assert type(t) is tconfig.SystemConfig
    assert type(t.orb) is tconfig.OrbConfig and type(t.ba) is tconfig.BAConfig
    assert all(type(c) is tconfig.CameraConfig for c in t.cameras)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t == tconfig.dual_default().replace(
        orb=tconfig.OrbConfig(n_levels=4, brief_learned=True, pallas_fast=False),
        ba=tconfig.BAConfig(pose_iters=7), fps=15.0)
    # a part converts on its own, and converting the port's own object is
    # the identity
    assert config_from_reference(j.orb) == t.orb
    assert config_from_reference(t) == t
    with pytest.raises(TypeError):
        config_from_reference(3)


def test_learned_pattern_equals_the_reference():
    np.testing.assert_array_equal(tpattern.BIT_PATTERN_31, jpattern.BIT_PATTERN_31)
    ours = tpattern.learned_pattern()
    assert ours.shape == (256, 2, 2) and ours.dtype == np.int32
    np.testing.assert_array_equal(ours, jpattern.learned_pattern())
    # the port's tables take it for a negative seed
    np.testing.assert_array_equal(orb_tables.brief_pattern(-1), ours)
