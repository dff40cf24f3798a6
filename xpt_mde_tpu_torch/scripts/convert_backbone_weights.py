"""Offline tool: convert keras ImageNet backbone weights into the file
that initializes ``DepthNetPretrained`` backbones when
``Config.pretrained_weight`` is set (the default).

    python -m xpt_mde_tpu_torch.scripts.convert_backbone_weights EfficientNetB5 /data/xpt_mde

writes ``/data/xpt_mde/pretrained/EfficientNetB5.msgpack``, byte for byte
the file the JAX package's ``scripts/convert_backbone_weights.py`` writes,
so a file converted once serves both packages. Any of the 15 backbone
names (EfficientNetB0-B7, ResNet50V2, DenseNet121, MobileNetV2, VGG16,
Xception, NASNetMobile, NASNetLarge). Needs TensorFlow (keras) and the
keras weights (downloaded or cached; a third argument other than
``imagenet`` is passed to keras as ``weights``); training reads the file
without either.
"""

import sys
from pathlib import Path


def write_pretrained(params: dict, batch_stats: dict, datapath, net_name: str) -> Path:
    """``<datapath>/pretrained/<net_name>.msgpack`` from a flax-layout tree."""
    from xpt_mde_tpu_torch.utils.flax_msgpack import to_bytes

    out_dir = Path(datapath) / "pretrained"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{net_name}.msgpack"
    out.write_bytes(to_bytes({"params": params, "batch_stats": batch_stats}))
    return out


def convert(net_name: str, datapath, weights: str | None = "imagenet") -> Path:
    import tensorflow as tf

    from xpt_mde_tpu_torch.models.backbones import BACKBONE_NAMES
    from xpt_mde_tpu_torch.models.backbones.convert_keras import convert_backbone

    if net_name not in BACKBONE_NAMES:
        raise ValueError(f"unknown backbone {net_name}; one of {BACKBONE_NAMES}")
    # the weight layout does not depend on the input size: keras's default
    keras_model = getattr(tf.keras.applications, net_name)(include_top=False, weights=weights)
    out = write_pretrained(*convert_backbone(keras_model, net_name), datapath, net_name)
    print(f"[convert_backbone_weights] wrote {out}")
    return out


if __name__ == "__main__":
    convert(sys.argv[1], sys.argv[2], sys.argv[3] if len(sys.argv) > 3 else "imagenet")
