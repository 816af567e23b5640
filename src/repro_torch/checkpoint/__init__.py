from repro_torch.checkpoint.checkpoint import (latest_step, prune, restore,
                                               save, step_path, steps_in)
