"""The port's copy of ``paddle_tpu/models/smallnet.py``, built with the
port's layer API under the same layer and parameter names.

SmallNet for MNIST/CIFAR (reference: benchmark/paddle/image/
smallnet_mnist_cifar.py — 2 conv-pool + 2 fc)."""

from paddle_tpu_torch import activation, layer, networks


def smallnet(input, class_num=10, num_channels=3):
    c1 = networks.simple_img_conv_pool(input, filter_size=5, num_filters=32,
                                       pool_size=3, pool_stride=2,
                                       num_channel=num_channels,
                                       act=activation.Relu(), name="s1",
                                       padding=2)
    c2 = networks.simple_img_conv_pool(c1, filter_size=5, num_filters=64,
                                       pool_size=3, pool_stride=2,
                                       act=activation.Relu(), name="s2",
                                       padding=2)
    fc1 = layer.fc(c2, 128, act=activation.Relu(), name="s_fc1")
    return layer.fc(fc1, class_num, act=activation.Softmax(), name="s_out")


def lenet5(input, class_num=10):
    """(reference: v1_api_demo/mnist LeNet-ish conv config)"""
    c1 = networks.simple_img_conv_pool(input, filter_size=5, num_filters=20,
                                       pool_size=2, num_channel=1,
                                       act=activation.Relu(), name="l1")
    c2 = networks.simple_img_conv_pool(c1, filter_size=5, num_filters=50,
                                       pool_size=2, act=activation.Relu(),
                                       name="l2")
    fc1 = layer.fc(c2, 500, act=activation.Relu(), name="l_fc1")
    return layer.fc(fc1, class_num, act=activation.Softmax(), name="l_out")
