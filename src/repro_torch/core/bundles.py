"""ModelBundle factories for the paper's two evaluation settings (the
reference's ``core/bundles.py``)."""
from __future__ import annotations

from typing import Tuple

from repro_torch.core.cluster import ModelBundle
from repro_torch.data.synthetic import make_image_dataset, train_test_split
from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn


def make_paper_bundle(dataset: str, *, n: int = 8192, seed: int = 0,
                      eval_batch: int = 256) -> Tuple[ModelBundle, bool]:
    """Returns (bundle, noniid).  dataset: "mnist" | "cifar"."""
    if dataset == "mnist":
        from repro_torch.configs import mnist_cnn as C
        data = make_image_dataset(n, C.IMAGE_SHAPE, C.NUM_CLASSES, seed=seed,
                                  difficulty=0.35)
        eta, momentum, noniid = 0.1, 0.0, False
    elif dataset == "cifar":
        from repro_torch.configs import cifar_alexnet as C
        # the reference's calibration: the downsized AlexNet reaches a ~0.9
        # ceiling slowly, and SGDM at the MNIST rate diverges on this data
        data = make_image_dataset(n, C.IMAGE_SHAPE, C.NUM_CLASSES, seed=seed,
                                  difficulty=0.9, label_noise=0.1)
        eta, momentum, noniid = 0.02, 0.9, True
    else:
        raise KeyError(dataset)
    train, test = train_test_split(data, 0.15, seed=seed)

    def init(gen, device):
        return init_cnn(gen, device, image_shape=C.IMAGE_SHAPE,
                        channels=C.CHANNELS, hidden=C.HIDDEN,
                        num_classes=C.NUM_CLASSES)

    bundle = ModelBundle(init=init, loss=cnn_loss, accuracy=cnn_accuracy,
                         train_data=train, test_data=test, eta=eta,
                         momentum=momentum, eval_batch=eval_batch)
    return bundle, noniid
