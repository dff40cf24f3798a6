from xpt_mde_tpu_torch.training.augmentation import augmentation_factory
from xpt_mde_tpu_torch.training.optimizers import optimizer_factory
from xpt_mde_tpu_torch.training.train_step import (decode_image_features,
                                                   features_to_device, make_eval_step,
                                                   make_predict_step,
                                                   make_train_step)
