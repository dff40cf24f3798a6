from xpt_mde_tpu_torch.models.factory import ModelFactory, VodeModel
