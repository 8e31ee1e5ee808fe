"""The plain reference: float32 PyTorch and NumPy, nothing of the program.

transition.py replays a transition's tree for any architecture; what the
model is, is the architecture's module, named as a configuration's
"architecture" (benchmark/architecture.py). Each has

- `PARTS`: the weight parts as (name, dtype key) pairs, in the order that
  seeds their draws (benchmark/weights.py), the dtype the configuration's
  run "dtypes" under the key;
- `parts(cfg, control)`: the parts on meta by name; control: one
  precision below the configuration's where the architecture says;
- `latent_shape(cfg)`: (h, w, channels) of a latent, which the ancestral
  draws take;
- `Steps(models, [prompt1, prompt2, negative])`: one transition's model
  side on the built parts, with `ancestral`, `noise(seed)` (a latent
  [1,h,w,c]), `output(x, i, fracts)` (the guided model output of rows x at
  step i, the conditioning mixed by each row's fraction),
  `step(x, out, i, noise)` and `decode(z)` (a latent [1,h,w,c] to uint8
  and [-1,1] images [1,H,W,3]).
"""
