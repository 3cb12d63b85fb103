"""Parameter / layer attributes (reference: python/paddle/trainer_config_helpers/
attrs.py — ParameterAttribute and ExtraLayerAttribute)."""

from paddle_tpu_torch.core.param import ParamAttr as _CoreParamAttr


def ParamAttr(name=None, initial_std=None, initial_mean=0.0, initial_value=None,
              initializer=None, learning_rate=1.0, l1_rate=None, l2_rate=None,
              is_static=False, sparse_update=False):
    """Factory mirroring ParameterAttribute's signature."""
    if initial_value is not None and initializer is None:
        initializer = "constant"
    return _CoreParamAttr(
        name=name, initializer=initializer, initial_mean=initial_mean,
        initial_std=initial_std, initial_value=initial_value,
        learning_rate=learning_rate, l1_rate=l1_rate, l2_rate=l2_rate,
        is_static=is_static, sparse_update=sparse_update)


class ExtraAttr:
    """Extra layer attributes (reference: ExtraLayerAttribute — drop_rate,
    error_clipping_threshold, device)."""

    def __init__(self, drop_rate=None, error_clipping_threshold=None,
                 sharding=None):
        self.drop_rate = drop_rate
        self.error_clipping_threshold = error_clipping_threshold
        self.sharding = sharding  # TPU-native: per-layer mesh-axis hints


ExtraLayerAttribute = ExtraAttr
ParameterAttribute = ParamAttr

# v2 aliases (reference: python/paddle/v2/attr.py __all__ = Param/Extra/Hook)
Param = ParamAttr
Extra = ExtraAttr
