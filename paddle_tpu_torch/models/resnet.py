"""ResNet for ImageNet and CIFAR (counterpart of
``paddle_tpu/models/resnet.py``; reference: benchmark/paddle/image/
resnet.py — layer_num 50/101/152, 1000 classes, 3x224x224; the
north-star benchmark model per BASELINE.md).

Built on the layer API: conv_bn blocks with addto shortcuts; NHWC
throughout; matmul/conv operands rounded to the compute dtype (bf16 by
default). Layer and parameter names are the JAX package's, so weights
carry across through ``Parameters.to_tar``.
"""

from paddle_tpu_torch import activation, layer, pooling


def _stash_for(fused):
    """(stash dtype, stochastic rounding) of a deferral recipe, None for
    any other mode: "q8" an int8 stash, "defer" a bf16 one, "q8sr" int8
    with unbiased stochastic rounding."""
    if not isinstance(fused, str):
        return None
    return {"q8": ("int8", False), "defer": ("bf16", False),
            "q8sr": ("int8", True)}.get(fused)


def conv_bn_layer(input, ch_out, filter_size, stride, padding, active_type,
                  ch_in=None, name=None, fused=False):
    """(reference: resnet.py conv_bn_layer). ``fused=True`` runs the
    single-op conv→BN path (``layer.img_conv_bn``, ops/conv_bn.py:
    closed-form BN VJP); ``fused="int8"`` additionally stashes the
    backward's saved activations as int8. ``fused="q8"`` runs the q8
    pipeline (ops/q8.py: activations stored as int8, the BN affine and
    activation deferred into the consumer's prologue); ``"defer"`` the
    same with a bf16 stash, ``"q8sr"`` with stochastic rounding.
    ``"full"`` was retired by the JAX package and is refused."""
    if fused == "full":
        raise ValueError(
            "fused='full' (the retired conv backward kernels) is not a "
            "mode; use True, 'int8' or the q8/defer recipes")
    if _stash_for(fused):
        stash, sr = _stash_for(fused)
        return layer.img_conv_bn_q8(
            input, filter_size=filter_size, num_filters=ch_out,
            num_channels=ch_in, stride=stride, padding=padding,
            act=active_type, name=f"{name}_q8" if name else None,
            conv_name=f"{name}_conv" if name else None,
            bn_name=f"{name}_bn" if name else None,
            stash=stash, stochastic=sr)
    if fused:
        # explicit integer padding (not "SAME", which pads asymmetrically
        # at stride 2); param names mirror the unfused pair so
        # checkpoints are interchangeable between paths
        return layer.img_conv_bn(
            input, filter_size=filter_size, num_filters=ch_out,
            num_channels=ch_in, stride=stride, padding=padding,
            act=active_type, name=f"{name}_fused" if name else None,
            conv_name=f"{name}_conv" if name else None,
            bn_name=f"{name}_bn" if name else None,
            save8=(fused == "int8"))
    tmp = layer.img_conv(input, filter_size=filter_size, num_filters=ch_out,
                         num_channels=ch_in, stride=stride, padding=padding,
                         act=None, bias_attr=False,
                         name=f"{name}_conv" if name else None)
    return layer.batch_norm(tmp, act=active_type,
                            name=f"{name}_bn" if name else None)


def shortcut(input, ch_in, ch_out, stride, name=None, fused=False):
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, 0, None,
                             name=f"{name}_proj" if name else None,
                             fused=fused)
    return input


def _addto(inputs, act, name, fused):
    if _stash_for(fused):
        stash, sr = _stash_for(fused)
        return layer.addto_q8(inputs, act=act, name=name,
                              stash=stash, stochastic=sr)
    return layer.addto(inputs, act=act, name=name)


def bottleneck_block(input, ch_in, ch_out, stride, name=None, fused=False):
    """1x1 -> 3x3 -> 1x1(x4) with identity/projection shortcut
    (reference: resnet.py bottleneck_block)."""
    short = shortcut(input, ch_in, ch_out * 4, stride, name=name,
                     fused=fused)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, activation.Relu(),
                          name=f"{name}_a" if name else None, fused=fused)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, activation.Relu(),
                          name=f"{name}_b" if name else None, fused=fused)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, None,
                          name=f"{name}_c" if name else None, fused=fused)
    return _addto([conv3, short], activation.Relu(),
                  f"{name}_add" if name else None, fused)


def basic_block(input, ch_in, ch_out, stride, name=None, fused=False):
    short = shortcut(input, ch_in, ch_out, stride, name=name, fused=fused)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, activation.Relu(),
                          name=f"{name}_a" if name else None, fused=fused)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, None,
                          name=f"{name}_b" if name else None, fused=fused)
    return _addto([conv2, short], activation.Relu(),
                  f"{name}_add" if name else None, fused)


_DEPTH_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def resnet_imagenet(input, depth=50, class_num=1000, img_size=224,
                    stem_space_to_depth=False, fused_bn=False):
    """(reference: resnet.py:6 — 3x224x224, 1000 classes).
    stem_space_to_depth: compute the 7x7/s2 stem as a stride-1 conv over
    space-to-depth input (numerically identical;
    ``layer.space_to_depth_conv``).
    fused_bn: False, True or "int8" (``conv_bn_layer``; the stem keeps
    the unfused path), or a deferral recipe ("q8", "defer", "q8sr"):
    the residual trunk between ``res_q8_entry`` and ``res_q8_exit``
    keeps its activations as stashes with deferred BN / ReLU; the stem
    and head stay dense."""
    kind, counts = _DEPTH_CFG[depth]
    block = bottleneck_block if kind == "bottleneck" else basic_block
    expansion = 4 if kind == "bottleneck" else 1

    if stem_space_to_depth:
        tmp = layer.space_to_depth_conv(input, 7, 64, num_channels=3,
                                        act=None, img_size=img_size,
                                        name="res_conv1_conv")
        conv1 = layer.batch_norm(tmp, act=activation.Relu(),
                                 name="res_conv1_bn")
    else:
        conv1 = conv_bn_layer(input, 64, 7, 2, 3, activation.Relu(),
                              ch_in=3, name="res_conv1")
    pool1 = layer.img_pool(conv1, pool_size=3, stride=2, padding=1,
                           pool_type=pooling.Max(), name="res_pool1")

    ch_in = 64
    tmp = pool1
    if _stash_for(fused_bn):
        stash, sr = _stash_for(fused_bn)
        tmp = layer.q8_entry(tmp, name="res_q8_entry",
                             stash=stash, stochastic=sr)
    for stage, (n, ch_out) in enumerate(zip(counts, [64, 128, 256, 512])):
        for i in range(n):
            stride = 2 if (i == 0 and stage > 0) else 1
            tmp = block(tmp, ch_in, ch_out, stride,
                        name=f"res{stage+2}_{i}", fused=fused_bn)
            ch_in = ch_out * expansion
    if _stash_for(fused_bn):
        tmp = layer.q8_exit(tmp, name="res_q8_exit")
    pool = layer.img_pool(tmp, pool_size=7, stride=1,
                          pool_type=pooling.Avg(), name="res_gap")
    return layer.fc(pool, class_num, act=activation.Softmax(), name="res_fc")


def resnet_cifar10(input, depth=32, class_num=10, fused_bn=False,
                   width=16):
    """(reference: v1_api_demo/model_zoo resnet cifar variant).
    fused_bn: as ``resnet_imagenet``; the stem stays dense.
    width: base channel count (stages run width/2·width/4·width)."""
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, width, 3, 1, 1, activation.Relu(),
                          ch_in=3, name="rc_conv1")
    tmp = conv1
    if _stash_for(fused_bn):
        stash, sr = _stash_for(fused_bn)
        tmp = layer.q8_entry(tmp, name="rc_q8_entry", stash=stash,
                             stochastic=sr)
    ch_in = width
    for stage, ch_out in enumerate([width, 2 * width, 4 * width]):
        for i in range(n):
            stride = 2 if (i == 0 and stage > 0) else 1
            tmp = basic_block(tmp, ch_in, ch_out, stride,
                              name=f"rc{stage}_{i}", fused=fused_bn)
            ch_in = ch_out
    if _stash_for(fused_bn):
        tmp = layer.q8_exit(tmp, name="rc_q8_exit")
    pool = layer.img_pool(tmp, pool_size=8, stride=1,
                          pool_type=pooling.Avg(), name="rc_gap")
    return layer.fc(pool, class_num, act=activation.Softmax(), name="rc_fc")
