# The SPADE configs register with the shared JSON loader once, here, so any
# reader of a config file resolves their type names.
from cat_tpu_torch.core import spade_config  # noqa: F401
