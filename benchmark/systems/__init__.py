"""The program's side of each architecture, one module per name a
configuration gives under "architecture" (benchmark/architecture.py).
Each has

- `build(cfg, seed, device)`: the program's engine over the
  architecture's holder, built from the configuration with the weights
  of benchmark/weights.py drawn from the seed;
- `hooked(engine)`: the denoiser and the decoder modules whose forwards
  the traced runs put in the bench::unet and bench::vae ranges.
"""
