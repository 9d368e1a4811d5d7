"""The benchmark of the port (echorenderer_tpu_torch): `python3 -m echobench`
(run.py). It imports neither JAX nor the JAX package."""
