from repro_torch.kernels.cd_solver.ops import (cd_epoch, cd_epochs,
                                               cd_epochs_wave, cd_polish,
                                               cd_wave_epoch)

__all__ = ["cd_epoch", "cd_epochs", "cd_epochs_wave", "cd_polish",
           "cd_wave_epoch"]
