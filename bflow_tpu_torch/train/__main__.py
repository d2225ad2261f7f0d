"""python -m bflow_tpu_torch.train <overrides>: the training loop
(bflow_tpu_torch/train/loop.py) on the GPU."""

from bflow_tpu_torch.train.loop import main

if __name__ == "__main__":
    main()
