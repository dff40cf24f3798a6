"""The constants of ``xpt_mde_tpu.config`` that the port's slice needs.

Copied, not imported: the port imports nothing of the JAX package.
``tests/test_torch_data.py`` holds every value here equal to the
reference's.
"""

SNIPPET_LEN = 5
NUM_SRC = SNIPPET_LEN - 1

# per-scale loss weights, finest scale first
SCALE_WEIGHT_T1 = tuple(w * 4.0 for w in (0.25, 0.25, 0.25, 0.25))
SCALE_WEIGHT_T2 = tuple(w * 4.0 for w in (0.1, 0.2, 0.3, 0.4))

# the rigid stage's nets (depth + camera of the reference's JOINT_NET)
RIGID_NET = {"depth": "EfficientNetB5", "camera": "PoseNetImproved"}
# the flow pre-training stage's net and loss recipe
FLOW_NET = {"flow": "PWCNet"}
LOSS_FLOW = {"flowL2": 1.0, "flowL2_R": 1.0, "flow_reg": 4e-7}

# PWC-Net's largest displacement, at stride 1 (level p searches 128 / 2^p)
MAX_DISPLACEMENT = 128

# the default augmentation probabilities (the reference's
# ``Config.augment_probs``)
AUGMENT_PROBS = {"CropAndResize": 0.2, "HorizontalFlip": 0.2, "ColorJitter": 0.2}
