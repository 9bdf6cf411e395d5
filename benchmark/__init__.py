"""The benchmark of the PyTorch and CUDA port (`isopoints_torch`): whole-view
renders through `Generator.raytrace_images` on one H100. See README.md."""
