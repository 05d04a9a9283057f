"""The default AdamW chain and the LR schedules (``repro/optim``)."""
from repro_torch.optim.schedule import lr_at  # noqa: F401
from repro_torch.optim.transforms import (  # noqa: F401
    GradientTransform, add_decayed_weights, apply_updates, build_optimizer,
    chain, clip_global_norm, decay_mask_tree, scale_by_adam, scale_by_lr,
    tree_leaves, tree_map)
