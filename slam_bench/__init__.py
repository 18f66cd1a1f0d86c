"""The benchmark of the PyTorch and CUDA port (`lidar_slam_tpu_torch`): see
README.md. Imports nothing of the JAX package."""
