"""Joint multi-dataset training CLI of the port (root ``multi_train.py``).

    python -m end2end_asr_tpu_torch.multi_train \\
        --train-manifest-list a_train.csv b_train.csv \\
        --valid-manifest-list a_dev.csv b_dev.csv ... [--device cpu]

The flags of ``train``: each batch row draws its manifest at random
(``data/dataset.py``), and task i's valid set is valid manifest i, with a
``(Epoch N) TASK:i VALID LOSS:…`` line per task and the best model keyed
off the mean of the tasks' losses (``training.trainer.MultiTrainer``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from end2end_asr_tpu_torch import train


def main(argv: Optional[List[str]] = None) -> Dict:
    from end2end_asr_tpu_torch.training.trainer import MultiTrainer
    return train.main(argv, trainer_cls=MultiTrainer)


if __name__ == "__main__":
    main()
