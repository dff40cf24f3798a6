from xpt_mde_tpu_torch.losses.photometric import (photometric_loss_l1,
                                                  photometric_loss_ssim)
from xpt_mde_tpu_torch.losses.total import (TotalLoss, check_loss_dependency,
                                            loss_factory)
