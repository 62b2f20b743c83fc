"""The paper's MNIST CNN (the reference's ``configs/mnist_cnn.py``):
conv 3x3x16 -> pool -> conv 3x3x32 -> pool -> dense 64 -> dense 10 on
28x28x1 images, 105,866 parameters (SGD, eta 0.1, lambda 5, window 10).
"""

IMAGE_SHAPE = (28, 28, 1)
CHANNELS = (16, 32)
HIDDEN = 64
NUM_CLASSES = 10
