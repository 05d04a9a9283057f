"""The optimizer chain, the legacy AdamW and the LR schedules
(``repro/optim``)."""
from repro_torch.optim.schedule import lr_at  # noqa: F401
from repro_torch.optim.transforms import (  # noqa: F401
    GradientTransform, abstract_chain_state, adaptive_grad_clip,
    add_decayed_weights, apply_updates, build_optimizer, chain,
    clip_global_norm, decay_mask_tree, migrate_opt_state, optimizer_step,
    per_leaf_update_telemetry, scale_by_adam, scale_by_lr, scale_by_shampoo, scale_by_sm3,
    scale_per_leaf, tree_leaves, tree_map)
