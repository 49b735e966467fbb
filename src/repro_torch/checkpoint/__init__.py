from repro_torch.checkpoint.io import latest_step_dir, restore, save

__all__ = ["latest_step_dir", "restore", "save"]
