"""The paper's downsized AlexNet (the reference's
``configs/cifar_alexnet.py``): conv 3x3x48 -> pool -> conv 3x3x96 -> pool
-> conv 3x3x192 -> pool -> dense 256 -> dense 10 on 32x32x3 images,
998,250 parameters (SGD with momentum 0.9).
"""

IMAGE_SHAPE = (32, 32, 3)
CHANNELS = (48, 96, 192)
HIDDEN = 256
NUM_CLASSES = 10
