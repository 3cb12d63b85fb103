"""The port's copy of ``paddle_tpu/models/vgg.py``, built with the
port's layer API under the same layer and parameter names.

VGG (reference: benchmark/paddle/image/vgg.py — img_conv_group stacks,
VGG-16/19)."""

from paddle_tpu_torch import activation, layer, pooling


def _conv_group(input, num_convs, num_filters, name, num_channels=None):
    tmp = input
    for i in range(num_convs):
        tmp = layer.img_conv(tmp, filter_size=3, num_filters=num_filters,
                             num_channels=num_channels if i == 0 else None,
                             padding=1, act=activation.Relu(),
                             name=f"{name}_c{i}")
    return layer.img_pool(tmp, 2, stride=2, pool_type=pooling.Max(),
                          name=f"{name}_pool")


_CFG = {11: [1, 1, 2, 2, 2], 13: [2, 2, 2, 2, 2],
        16: [2, 2, 3, 3, 3], 19: [2, 2, 4, 4, 4]}


def vgg(input, depth=19, class_num=1000):
    counts = _CFG[depth]
    tmp = input
    chans = 3
    for i, (n, f) in enumerate(zip(counts, [64, 128, 256, 512, 512])):
        tmp = _conv_group(tmp, n, f, name=f"v{i+1}",
                          num_channels=chans if i == 0 else None)
    fc1 = layer.fc(tmp, 4096, act=activation.Relu(), name="v_fc1")
    d1 = layer.dropout(fc1, 0.5, name="v_drop1")
    fc2 = layer.fc(d1, 4096, act=activation.Relu(), name="v_fc2")
    d2 = layer.dropout(fc2, 0.5, name="v_drop2")
    return layer.fc(d2, class_num, act=activation.Softmax(), name="v_out")


def vgg16(input, class_num=1000):
    return vgg(input, 16, class_num)


def vgg19(input, class_num=1000):
    return vgg(input, 19, class_num)
