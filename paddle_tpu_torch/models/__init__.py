"""Model zoo (counterpart of ``paddle_tpu/models/``; reference:
benchmark/paddle/image/{alexnet,googlenet,vgg,resnet,
smallnet_mnist_cifar}.py, v1_api_demo/ configs): the layer-API builders
``alexnet``, ``vgg``, ``googlenet``, ``resnet``, ``smallnet``, ``text``,
``seq2seq`` and ``ctr``; the functional ``gan`` and ``vae`` with their
own trainers; and the decoder-only ``transformer`` LM."""

from paddle_tpu_torch.models import alexnet  # noqa: F401
from paddle_tpu_torch.models import ctr  # noqa: F401
from paddle_tpu_torch.models import googlenet  # noqa: F401
from paddle_tpu_torch.models import resnet  # noqa: F401
from paddle_tpu_torch.models import smallnet  # noqa: F401
from paddle_tpu_torch.models import seq2seq  # noqa: F401
from paddle_tpu_torch.models import text  # noqa: F401
from paddle_tpu_torch.models import vgg  # noqa: F401
from paddle_tpu_torch.models import gan  # noqa: F401
from paddle_tpu_torch.models import vae  # noqa: F401
