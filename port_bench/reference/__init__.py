"""The plain references that decide ``correct``, and their controls.

Plain PyTorch, in float32 with TF32 off (or exact integers), imported from
nothing of the program. Each reference works its inputs out again from the
recipe the benchmark or the configuration states, and reads the program's
outputs only to judge them. Each has a control: the same computation in
the nearest precision below the one the configuration states (fp8 for
bf16, bf16 accumulation for f32), which the comparison must reject.
"""
