"""``python -m paddle_tpu_torch.core.build``: compile the native host
runtime library (if its sources changed) and print its path."""

from paddle_tpu_torch.core.native import build

if __name__ == "__main__":
    print(build(verbose=True))
