"""ImageNet normalization statistics (unidepth_tpu/utils/constants.py)."""

IMAGENET_DATASET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DATASET_STD = (0.229, 0.224, 0.225)
