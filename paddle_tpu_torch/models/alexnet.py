"""The port's copy of ``paddle_tpu/models/alexnet.py``, built with the
port's layer API under the same layer and parameter names.

AlexNet (reference: benchmark/paddle/image/alexnet.py — 227x227x3 input,
conv widths 96/256/384/384/256, conv1 11x11 s4 p1, LRN size 5 scale 1e-4
power 0.75, 3x3 s2 max pools, 4096-4096-1000 fc head with dropout 0.5)."""

from paddle_tpu_torch import activation, layer, pooling


def alexnet(input, class_num=1000, img_size=227):
    conv1 = layer.img_conv(input, filter_size=11, num_filters=96,
                           num_channels=3, stride=4, padding=1,
                           act=activation.Relu(), name="a_conv1",
                           img_size=img_size)
    norm1 = layer.img_cmrnorm(conv1, size=5, scale=0.0001, power=0.75,
                              name="a_norm1")
    pool1 = layer.img_pool(norm1, 3, stride=2, pool_type=pooling.Max(),
                           name="a_pool1")
    conv2 = layer.img_conv(pool1, filter_size=5, num_filters=256, padding=2,
                           act=activation.Relu(), name="a_conv2")
    norm2 = layer.img_cmrnorm(conv2, size=5, scale=0.0001, power=0.75,
                              name="a_norm2")
    pool2 = layer.img_pool(norm2, 3, stride=2, pool_type=pooling.Max(),
                           name="a_pool2")
    conv3 = layer.img_conv(pool2, filter_size=3, num_filters=384, padding=1,
                           act=activation.Relu(), name="a_conv3")
    conv4 = layer.img_conv(conv3, filter_size=3, num_filters=384, padding=1,
                           act=activation.Relu(), name="a_conv4")
    conv5 = layer.img_conv(conv4, filter_size=3, num_filters=256, padding=1,
                           act=activation.Relu(), name="a_conv5")
    pool3 = layer.img_pool(conv5, 3, stride=2, pool_type=pooling.Max(),
                           name="a_pool3")
    fc1 = layer.fc(pool3, 4096, act=activation.Relu(), name="a_fc1")
    d1 = layer.dropout(fc1, 0.5, name="a_drop1")
    fc2 = layer.fc(d1, 4096, act=activation.Relu(), name="a_fc2")
    d2 = layer.dropout(fc2, 0.5, name="a_drop2")
    return layer.fc(d2, class_num, act=activation.Softmax(), name="a_out")
