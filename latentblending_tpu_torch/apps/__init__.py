"""The example scripts of the port, each run as
`python -m latentblending_tpu_torch.apps.<name>` with the flags of the JAX
package's apps/ scripts, plus --device (default cuda)."""
