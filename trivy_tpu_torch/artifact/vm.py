"""VM disk-image artifact (pkg/fanal/artifact/vm/vm.go).

Walks every ext/XFS partition of a raw disk image through the analyzer
group, producing one blob per partition keyed on the image digest +
partition offset + analyzer versions (the content-addressed cache
contract).

Copied from `trivy_tpu/artifact/vm.py`;
the port imports nothing from the JAX package.  The partition keys hash
`AnalyzerOptions.cache_key_extra` (`rekor=<url>` under the rekor SBOM
source, else "") as the reference's do, and equal them.  The port adds host spans
`vm.open`, `vm.partition`, `artifact.post` and `cache.put` beside the
analyzer group's (the partition's file walk is `analyzer.walk`).  The secret analyzer's engine
runs on `AnalyzerOptions.device`; a disk with no readable filesystem logs
and yields an empty blob, as in the reference.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os

from trivy_tpu_torch.analyzer.core import AnalyzerGroup, AnalyzerOptions
from trivy_tpu_torch.atypes import ArtifactInfo, ArtifactReference, BlobInfo
from trivy_tpu_torch.ftypes import ArtifactType
from trivy_tpu_torch.cache.store import ArtifactCache
from trivy_tpu_torch.handler import run_post_handlers
from trivy_tpu_torch.vm import Ext4Error, Ext4Reader, is_ext, is_lvm, list_partitions
from trivy_tpu_torch.walker.fs import FileEntry

logger = logging.getLogger(__name__)


class VMArtifact:
    def __init__(
        self,
        target: str,
        cache: ArtifactCache,
        analyzer_options: AnalyzerOptions | None = None,
    ):
        self.target = target
        self.cache = cache
        self.group = AnalyzerGroup(analyzer_options)

    def _image_digest(self) -> str:
        if self.target.startswith(("ebs:", "ami:")):
            # Remote snapshots are content-addressed by their immutable id.
            h = hashlib.sha256(self.target.encode())
            return "sha256:" + h.hexdigest()
        h = hashlib.sha256()
        with open(self.target, "rb") as f:
            # Digest head+tail+size: hashing a multi-GB image in full would
            # dominate scan time; partition tables and superblocks pin the
            # identity well enough for cache keying.
            h.update(f.read(1 << 20))
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - (1 << 20)))
            h.update(f.read(1 << 20))
            h.update(str(size).encode())
        return "sha256:" + h.hexdigest()

    def _open_image(self):
        """(file-like, size): local raw image, local VMDK (wrapped into
        its flat view), or a remote EBS snapshot (`ebs:`/`ami:` targets)."""
        from trivy_tpu_torch.vm.ebs import open_vm_target
        from trivy_tpu_torch.vm.vmdk import VmdkFile, is_vmdk

        remote = open_vm_target(self.target)
        if remote is not None:
            return remote, remote.size
        raw = open(self.target, "rb")
        if is_vmdk(raw):
            vmdk = VmdkFile(raw)
            return vmdk, vmdk.size
        return raw, os.path.getsize(self.target)

    def inspect(self) -> ArtifactReference:
        from trivy_tpu_torch.obs import trace as obs_trace

        digest = self._image_digest()
        # walker-version component: bump when partition/LV traversal
        # changes what a scan can see (v2: LVM2 linear LV support) —
        # cached empty results from older walkers must not stick.
        versions = (
            json.dumps(self.group.analyzer_versions(), sort_keys=True)
            + self.group.options.cache_key_extra
            + "|vm-walker:4"  # v4: VMDK + EBS/AMI sources
        )
        with obs_trace.span("vm.open"):
            img, size = self._open_image()
        blob_ids: list[str] = []
        try:
            partitions = list_partitions(img, size)
            keys = []
            for part in partitions:
                key_h = hashlib.sha256()
                key_h.update(digest.encode())
                key_h.update(str(part.offset).encode())
                key_h.update(versions.encode())
                keys.append("sha256:" + key_h.hexdigest())
            blob_ids.extend(keys)
            # One batched round-trip (the image artifact's pattern) instead
            # of a HEAD pair per partition on remote backends.
            _missing_artifact, missing = self.cache.missing_blobs(digest, keys)
            for part, key in zip(partitions, keys):
                if key not in missing:
                    continue
                with obs_trace.span("vm.partition", index=part.index):
                    blob = self._inspect_partition(img, part)
                with obs_trace.span("cache.put"):
                    self.cache.put_blob(key, blob)
        finally:
            close = getattr(img, "close", None)
            if close is not None:
                close()
        self.cache.put_artifact(digest, ArtifactInfo())
        return ArtifactReference(
            name=self.target,
            artifact_type=ArtifactType.VM.value,
            id=digest,
            blob_ids=blob_ids,
        )

    def _inspect_partition(self, img, part) -> BlobInfo:
        if is_lvm(img, part.offset):
            # LVM physical volume: map its linear logical volumes and walk
            # each ext filesystem found inside (vm.go:195 / go-lvm).
            from trivy_tpu_torch.vm.lvm import LVReader, LvmError, logical_volumes

            try:
                lvs = logical_volumes(img, part.offset)
            except LvmError as e:
                logger.warning(
                    "partition %d: unreadable LVM metadata (%s); skipped",
                    part.index, e,
                )
                return BlobInfo()
            merged = BlobInfo()
            scanned = 0
            from trivy_tpu_torch.vm.xfs import is_xfs

            for lv in lvs:
                view = LVReader(img, lv)
                if not (is_ext(view, 0) or is_xfs(view, 0)):
                    logger.info(
                        "LV %s/%s holds no ext/XFS filesystem; skipped",
                        lv.vg_name, lv.name,
                    )
                    continue
                scanned += 1
                merged = self._merge_blob(
                    merged, self._inspect_fs(view, 0, f"LV {lv.name}")
                )
            if not scanned:
                logger.warning(
                    "partition %d: no readable linear LVs", part.index
                )
            return merged
        from trivy_tpu_torch.vm.xfs import is_xfs

        if not (is_ext(img, part.offset) or is_xfs(img, part.offset)):
            logger.info(
                "partition %d holds no ext/XFS filesystem; skipped",
                part.index,
            )
            return BlobInfo()
        return self._inspect_fs(img, part.offset, f"partition {part.index}")

    @staticmethod
    def _merge_blob(into: BlobInfo, other: BlobInfo) -> BlobInfo:
        into.os = into.os or other.os
        into.package_infos.extend(other.package_infos)
        into.applications.extend(other.applications)
        into.secrets.extend(other.secrets)
        into.licenses.extend(other.licenses)
        into.misconfigurations.extend(other.misconfigurations)
        into.custom_resources.extend(other.custom_resources)
        into.build_info = into.build_info or other.build_info
        return into

    def _inspect_fs(self, img, offset: int, what: str) -> BlobInfo:
        """Walk one ext or XFS filesystem through the analyzer group."""
        from trivy_tpu_torch.vm.xfs import XfsError, XfsReader, is_xfs

        try:
            if is_xfs(img, offset):
                reader = XfsReader(img, offset)
            else:
                reader = Ext4Reader(img, offset)
        except (Ext4Error, XfsError) as e:
            logger.warning("%s: %s", what, e)
            return BlobInfo()

        def entries():
            # Structural failures mid-walk (btree dirs, corrupt entries)
            # end THIS filesystem's walk loudly with whatever was already
            # yielded — one bad directory must not abort the disk scan;
            # per-FILE opener failures are handled downstream (OSError
            # tolerance in _read_inputs).
            it = reader.walk()
            while True:
                try:
                    e = next(it)
                except StopIteration:
                    return
                except (Ext4Error, XfsError) as err:
                    logger.warning("%s: walk aborted: %s", what, err)
                    return
                yield FileEntry(
                    path=e.path, size=e.size, mode=e.mode, opener=e.opener
                )

        from trivy_tpu_torch.obs import trace as obs_trace

        result = self.group.analyze_entries("", entries())
        with obs_trace.span("artifact.post"):
            result.merge(self.group.post_analyze())
        run_post_handlers(result)
        result.sort()
        return BlobInfo(
            os=result.os,
            package_infos=list(result.package_infos),
            applications=list(result.applications),
            secrets=list(result.secrets),
            licenses=list(result.licenses),
            misconfigurations=list(result.misconfigs),
            custom_resources=list(result.configs),
            build_info=result.build_info,
        )

    def clean(self, ref: ArtifactReference) -> None:
        pass
