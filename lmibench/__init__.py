"""lmibench: the end-to-end benchmark of `tpulmi_torch` on one card.

One command runs one cell once (``python3 lmibench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>``); README.md says what each
file is for. Nothing here imports JAX or the JAX package.
"""
