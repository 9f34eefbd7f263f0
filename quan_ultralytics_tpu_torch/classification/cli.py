"""classification.py-compatible CLI of the PyTorch port (counterpart of the
JAX ``classification/cli.py``; reference classification/classification.py:43-291):

    python -m quan_ultralytics_tpu_torch.classification.cli \\
        --model qwrn16_2 --dataset cifar10 --data_dir data --mapping poincare --epochs 100

The JAX CLI's flags, plus ``--device`` (default ``cuda``; without a card it
exits non-zero unless ``--device cpu`` is given). ``--resume`` takes a
checkpoint of either package; ``--dataset synthetic`` needs no files;
``--autoaugment`` applies the CIFAR-10 AutoAugment policy to the train images
of the array datasets (CIFAR, SVHN, synthetic), as the JAX CLI does.
"""

from __future__ import annotations

import argparse

from quan_ultralytics_tpu_torch.classification.data import (
    CIFAR10_MEAN, CIFAR10_STD, CIFAR100_MEAN, CIFAR100_STD,
    batches, imagenet_batches, imagenet_folder_samples, load_cifar, load_svhn, make_synthetic,
)
from quan_ultralytics_tpu_torch.classification.models import MODEL_FACTORIES
from quan_ultralytics_tpu_torch.classification.train import ClsConfig, ExperimentManager, fit
from quan_ultralytics_tpu_torch.models.tasks import resolve_device
from quan_ultralytics_tpu_torch.ops.mappings import MAPPING_TYPES

DATASET_CLASSES = {"cifar10": 10, "cifar100": 100, "svhn": 10, "imagenet": 1000, "synthetic": 10}


def build_parser():
    p = argparse.ArgumentParser(description="QUAN classification training (PyTorch/CUDA)")
    p.add_argument("--model", default="qwrn16_2", choices=sorted(MODEL_FACTORIES))
    p.add_argument("--dataset", default="cifar10", choices=sorted(DATASET_CLASSES))
    p.add_argument("--data_dir", default="data")
    p.add_argument("--mapping", default="poincare", choices=sorted(MAPPING_TYPES))
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--drop_rate", type=float, default=0.0)
    p.add_argument("--cutout", type=int, default=0)
    p.add_argument("--num_augments", type=int, default=1,
                   help="augmented copies per image per epoch (MultiAugmentDataset)")
    p.add_argument("--autoaugment", action="store_true", help="CIFAR-10 AutoAugment policy")
    p.add_argument("--resume", default=None)
    p.add_argument("--exp_dir", default="runs/classify")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:  # no silent CPU run: without a card, only --device cpu runs
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"classification: {e}")
    nc = DATASET_CLASSES[args.dataset]
    cfg = ClsConfig(
        model=args.model, dataset=args.dataset, data_dir=args.data_dir,
        mapping=args.mapping, epochs=args.epochs, batch_size=args.batch_size,
        lr=args.lr, weight_decay=args.weight_decay, drop_rate=args.drop_rate,
        num_classes=nc, seed=args.seed, exp_dir=args.exp_dir,
    )

    if args.dataset == "imagenet":
        tr_files, tr_labels, _ = imagenet_folder_samples(args.data_dir, "train")
        va_files, va_labels, _ = imagenet_folder_samples(args.data_dir, "val")
        steps_per_epoch = len(tr_files) // cfg.batch_size

        def train_loader(epoch):
            return imagenet_batches(tr_files, tr_labels, cfg.batch_size, train=True, seed=cfg.seed + epoch)

        def val_loader():
            return imagenet_batches(va_files, va_labels, cfg.batch_size, train=False)
    else:
        if args.dataset in ("cifar10", "cifar100"):
            tx, ty, vx, vy = load_cifar(args.data_dir, args.dataset)
        elif args.dataset == "svhn":
            tx, ty, vx, vy = load_svhn(args.data_dir)
        else:
            tx, ty, vx, vy = make_synthetic(nc)
        mean, std = (CIFAR100_MEAN, CIFAR100_STD) if args.dataset == "cifar100" else (CIFAR10_MEAN, CIFAR10_STD)
        steps_per_epoch = len(tx) * max(args.num_augments, 1) // cfg.batch_size

        def train_loader(epoch):
            return batches(tx, ty, cfg.batch_size, train=True, mean=mean, std=std,
                           cutout_len=args.cutout, seed=cfg.seed + epoch, num_augments=args.num_augments,
                           auto_augment=args.autoaugment)

        def val_loader():
            return batches(vx, vy, cfg.batch_size, train=False, mean=mean, std=std)

    start_state, start_epoch = None, 0
    if args.resume:
        start_state = ExperimentManager.load_checkpoint(args.resume)
        start_epoch = start_state["epoch"] + 1
        print(f"resumed from {args.resume} at epoch {start_epoch}")

    _, exp = fit(cfg, train_loader, val_loader, steps_per_epoch, start_state=start_state,
                 start_epoch=start_epoch, device=device)
    print(f"best top1: {exp.best_acc:.4f}  (exp dir: {exp.dir})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
