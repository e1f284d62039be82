"""The benchmark's plain reference: text-to-image in float32 PyTorch and
NumPy (the Fourier features of the timestep and time ids in the
configuration's dtype, ``ops.for_config``), written from the published architectures (CLIP text transformer,
UNet2DConditionModel, AutoencoderKL's decoder, k-diffusion's euler and
euler_a, OnnxStream's seeded noise). It imports nothing of the program under
test: it takes the benchmark's weights by name and the request's prompt,
seed and schedule, and works out everything else itself."""
