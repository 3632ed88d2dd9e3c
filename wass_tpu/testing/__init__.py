from wass_tpu.testing.synthetic import (  # noqa: F401
    SyntheticScene, SyntheticRig, add_offband_object, make_rig, make_scene,
)
