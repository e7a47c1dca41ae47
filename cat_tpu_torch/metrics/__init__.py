from cat_tpu_torch.metrics.deeplabv2 import MSC, DeepLabV2  # noqa: F401
