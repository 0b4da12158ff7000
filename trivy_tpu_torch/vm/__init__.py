"""VM disk-image scanning (pkg/fanal/artifact/vm + walker/vm.go).

Raw disk images, VMDKs (`vmdk.py`) and EBS snapshots (`ebs.py`) open as
one seekable view; partitions enumerate via MBR (with its EBR chain) or
GPT (bare filesystems scan as one partition), LVM2 physical volumes map
their linear logical volumes (`lvm.py`), ext2/3/4 and XFS filesystems walk
with from-scratch readers (`ext4.py`, `xfs.py`), and each file feeds the
same analyzer group the filesystem artifact uses.  Other filesystems are
logged and skipped.

Copied from `trivy_tpu/vm/__init__.py`;
the port imports nothing from the JAX package.
"""

from trivy_tpu_torch.vm.disk import Partition, is_ext, is_lvm, list_partitions
from trivy_tpu_torch.vm.ext4 import Ext4Error, Ext4Reader

__all__ = [
    "Partition",
    "list_partitions",
    "is_ext",
    "is_lvm",
    "Ext4Reader",
    "Ext4Error",
]
