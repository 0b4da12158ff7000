"""IaC fixtures: a failing and a passing input for builtin checks, a seeded
tree of Terraform, Kubernetes, Dockerfile, CloudFormation, Helm, ARM and
TOML files with the checks each file plants, and an image config whose
history trips Dockerfile checks.

Builders for the port's tests and `chip_smoke.py`; the scanner never
imports this module.  `CHECK_FIXTURES` maps a builtin check's file name
(`iac/checks/<name>.rego`) to its id, the file name it is scanned under,
an input that fails it and one that passes it.  `iac_tree` lays those
inputs out as a user's repository would hold them: Terraform root modules
with `terraform.tfvars` and a local child module whose check turns on the
caller's argument, multi-document manifests, Helm charts rendered from
their values, and TOML files that only a custom check (`TOML_CHECK`, given
with `--config-check`) reads.
"""

from __future__ import annotations

import json

# a custom check over TOML inputs, for `--config-check DIR`
TOML_CHECK_ID = "USR-TOML-001"
TOML_CHECK = f"""# METADATA
# title: telnet enabled
# custom:
#   id: {TOML_CHECK_ID}
#   severity: HIGH
package user.toml.telnet

deny[res] {{
    input.telnet == true
    res := result.new("telnet must be disabled", input)
}}
"""

CFN_HEADER = "AWSTemplateFormatVersion: '2010-09-09'\nResources:\n"
POD_HEADER = "apiVersion: v1\nkind: Pod\nmetadata:\n  name: p\n"

# CloudFormation: {check file: (id, resource type, failing properties,
# passing properties)}, rendered as YAML or JSON templates.
CFN = {
    "cfn_aws_public_ip": ("AVD-AWS-0164", "AWS::EC2::Subnet", {"MapPublicIpOnLaunch": True},
                          {"MapPublicIpOnLaunch": False}),
    "cfn_aws_s3_acl": ("AVD-AWS-0092", "AWS::S3::Bucket", {"AccessControl": "PublicRead"},
                       {"AccessControl": "Private"}),
    "cfn_aws_ebs_encryption": ("AVD-AWS-0026", "AWS::EC2::Volume", {"Size": 10},
                               {"Size": 10, "Encrypted": True}),
    "cfn_aws_instance_metadata": ("AVD-AWS-0028", "AWS::EC2::Instance", {"ImageId": "ami-1"},
                                  {"MetadataOptions": {"HttpTokens": "required"}}),
    "cfn_aws_rds_encryption": ("AVD-AWS-0080", "AWS::RDS::DBInstance", {"Engine": "mysql"},
                               {"StorageEncrypted": True}),
    "cfn_aws_s3_encryption": (
        "AVD-AWS-0088", "AWS::S3::Bucket", {"BucketName": "b"},
        {"BucketEncryption": {"ServerSideEncryptionConfiguration": [
            {"ServerSideEncryptionByDefault": {"SSEAlgorithm": "aws:kms"}}]}}),
    "cfn_aws_s3_versioning": ("AVD-AWS-0090", "AWS::S3::Bucket", {"BucketName": "b"},
                              {"VersioningConfiguration": {"Status": "Enabled"}}),
    "cfn_aws_sg_open_ingress": (
        "AVD-AWS-0107", "AWS::EC2::SecurityGroup",
        {"SecurityGroupIngress": [{"CidrIp": "0.0.0.0/0", "FromPort": 22, "ToPort": 22,
                                   "IpProtocol": "tcp"}]},
        {"SecurityGroupIngress": [{"CidrIp": "10.0.0.0/8", "FromPort": 22, "ToPort": 22,
                                   "IpProtocol": "tcp"}]}),
}

DOCKER = {
    "docker_ds002": ("DS002", "FROM alpine:3.19\nUSER root\n", "FROM alpine:3.19\nUSER app\n"),
    "docker_ds004": ("DS004", "FROM alpine:3.19\nEXPOSE 22\n", "FROM alpine:3.19\nEXPOSE 8080\n"),
    "docker_ds005": ("DS005", "FROM alpine:3.19\nADD app.py /app/\n",
                     "FROM alpine:3.19\nCOPY app.py /app/\n"),
    "docker_ds010": ("DS010", "FROM alpine:3.19\nRUN sudo make install\n",
                     "FROM alpine:3.19\nRUN make install\n"),
    "docker_ds013": ("DS013", "FROM alpine:3.19\nRUN cd /app && make\n",
                     "FROM alpine:3.19\nWORKDIR /app\nRUN make\n"),
    "docker_ds015": ("DS015", "FROM centos:7\nRUN yum install -y git\n",
                     "FROM centos:7\nRUN yum install -y git && yum clean all\n"),
    "docker_ds016": ("DS016", 'FROM alpine:3.19\nCMD ["a"]\nCMD ["b"]\n',
                     'FROM alpine:3.19\nCMD ["b"]\n'),
    "docker_ds021": ("DS021", "FROM debian:12\nRUN apt-get -y upgrade\n",
                     "FROM debian:12\nRUN apt-get -y install --no-install-recommends git\n"),
    "docker_ds022": ("DS022", "FROM alpine:3.19\nMAINTAINER dev@example.com\n",
                     "FROM alpine:3.19\nLABEL maintainer=dev@example.com\n"),
    "docker_ds025": ("DS025", "FROM alpine:3.19\nRUN apk add git\n",
                     "FROM alpine:3.19\nRUN apk add --no-cache git\n"),
}


def _pod(sec: str = "", spec: str = "") -> str:
    return (POD_HEADER + "spec:\n" + spec + "  containers:\n    - name: app\n"
            "      image: nginx:1.25\n" + sec)


K8S = {
    "k8s_ksv009": ("KSV009", _pod(spec="  hostNetwork: true\n"),
                   _pod(spec="  hostNetwork: false\n")),
    "k8s_ksv017": ("KSV017", _pod("      securityContext:\n        privileged: true\n"),
                   _pod("      securityContext:\n        privileged: false\n")),
    "k8s_ksv104": ("KSV104",
                   _pod("      securityContext:\n        seccompProfile:\n"
                        "          type: Unconfined\n"),
                   _pod("      securityContext:\n        seccompProfile:\n"
                        "          type: RuntimeDefault\n")),
}

TERRAFORM = {
    "tf_aws_iam_password_policy": (
        "AVD-AWS-0063",
        'resource "aws_iam_account_password_policy" "p" {\n  minimum_password_length = 8\n}\n',
        'resource "aws_iam_account_password_policy" "p" {\n  minimum_password_length = 14\n}\n'),
    "tf_aws_kms_rotation": (
        "AVD-AWS-0065", 'resource "aws_kms_key" "k" {\n  description = "k"\n}\n',
        'resource "aws_kms_key" "k" {\n  enable_key_rotation = true\n}\n'),
    "tf_aws_public_ip": (
        "AVD-AWS-0009",
        'resource "aws_instance" "i" {\n  associate_public_ip_address = true\n}\n',
        'resource "aws_instance" "i" {\n  associate_public_ip_address = false\n}\n'),
    "tf_aws_rds_public": (
        "AVD-AWS-0180", 'resource "aws_db_instance" "d" {\n  publicly_accessible = true\n}\n',
        'resource "aws_db_instance" "d" {\n  publicly_accessible = false\n}\n'),
    "tf_aws_s3_acl": (
        "AVD-AWS-0092", 'resource "aws_s3_bucket" "b" {\n  acl = "public-read"\n}\n',
        'resource "aws_s3_bucket" "b" {\n  acl = "private"\n}\n'),
}

ARM = {
    "arm_azure_storage_https": ("AVD-AZU-0008", {"supportsHttpsTrafficOnly": False},
                                {"supportsHttpsTrafficOnly": True}),
    "arm_azure_storage_public": ("AVD-AZU-0007", {"allowBlobPublicAccess": True},
                                 {"allowBlobPublicAccess": False}),
}


def cfn_template(rtype: str, props: dict, as_json: bool = False) -> str:
    if as_json:
        return json.dumps({"AWSTemplateFormatVersion": "2010-09-09",
                           "Resources": {"R": {"Type": rtype, "Properties": props}}}, indent=2)
    body = "\n".join("      " + line for line in json.dumps(props).splitlines())
    return CFN_HEADER + f"  R:\n    Type: {rtype}\n    Properties:\n{body}\n"


def arm_template(props: dict) -> str:
    return json.dumps({
        "$schema": "https://schema.management.azure.com/schemas/2019-04-01/"
                   "deploymentTemplate.json#",
        "contentVersion": "1.0.0.0",
        "resources": [{"type": "Microsoft.Storage/storageAccounts", "name": "acct",
                       "properties": props}]})


def _fixtures() -> dict:
    out = {}
    for name, (cid, rtype, bad, good) in CFN.items():
        out[name] = (cid, "stack.yaml", cfn_template(rtype, bad), cfn_template(rtype, good))
    for table, fname in ((DOCKER, "Dockerfile"), (K8S, "pod.yaml"), (TERRAFORM, "main.tf")):
        for name, (cid, bad, good) in table.items():
            out[name] = (cid, fname, bad, good)
    for name, (cid, bad, good) in ARM.items():
        out[name] = (cid, "azuredeploy.json", arm_template(bad), arm_template(good))
    return out


# {check file: (check id, file name, failing input, passing input)}
CHECK_FIXTURES = _fixtures()

# Helm: a chart whose deployment's privileged flag comes from its values
CHART_YAML = "apiVersion: v2\nname: {name}\nversion: 0.1.0\nappVersion: '2.1'\n"
VALUES_YAML = "replicaCount: 2\nimage:\n  repository: nginx\n  tag: ''\nprivileged: {priv}\n"
HELPERS_TPL = ('{{- define "app.fullname" -}}\n'
               '{{- printf "%s-%s" .Release.Name .Chart.Name | trunc 63 | trimSuffix "-" -}}\n'
               '{{- end -}}\n')
DEPLOYMENT_TPL = """apiVersion: apps/v1
kind: Deployment
metadata:
  name: {{ include "app.fullname" . }}
spec:
  replicas: {{ .Values.replicaCount }}
  template:
    spec:
      containers:
        - name: {{ .Chart.Name }}
          image: "{{ .Values.image.repository }}:{{ .Values.image.tag | default .Chart.AppVersion }}"
          securityContext:
            privileged: {{ .Values.privileged }}
"""

# Terraform: a root module whose tfvars decide its child module's argument
TF_ROOT = 'module "store" {\n  source  = "./modules/store"\n  encrypt = var.encrypt\n}\n'
TF_VARIABLES = 'variable "encrypt" {\n  default = true\n}\n'
TF_CHILD = ('variable "encrypt" {\n  default = true\n}\n'
            'resource "aws_ebs_volume" "data" {\n  size      = 10\n  encrypted = var.encrypt\n}\n')
TF_CHILD_CHECK = "AVD-AWS-0026"


def iac_tree(tf_dirs: int = 60, tf_files: int = 5, manifests: int = 400,
             dockerfiles: int = 150, templates: int = 150, charts: int = 4,
             configs: int = 100) -> tuple[dict, dict]:
    """({path: bytes}, {path: [(check id, fails)]}): the tree's files and,
    for each file that plants a check, whether the report must show it
    failing there (True) or must not (False).  The layout is fixed by the
    arguments: fixtures are taken in turn, failing and passing alternate.

    * `tf/stack<i>/`: `main.tf` calls `./modules/store` with `encrypt =
      var.encrypt`, `variables.tf`, `terraform.tfvars` (false in even
      stacks), the child `modules/store/main.tf` (AVD-AWS-0026 fails there
      exactly when the caller passes false), and `tf_files` fixture files
      (at most one a Terraform fixture: a module's resource addresses are
      unique);
    * `k8s/app<i>/manifest.yaml`: one pod, or (every fifth) the failing and
      the passing pod of one check as two documents;
    * `docker/svc<i>/Dockerfile`; `cfn/stack<i>.yaml` (every third a
      `.json` template); `helm/chart<i>/` (KSV017 fails in the rendered
      deployment of the even charts); `config/arm<i>.json` and
      `config/settings<i>.toml` (the latter read by `TOML_CHECK`)."""
    files: dict[str, str] = {}
    planted: dict[str, list] = {}

    def plant(path: str, text: str, check_id: str, fails: bool) -> None:
        files[path] = text
        planted.setdefault(path, []).append((check_id, fails))

    tf = list(TERRAFORM.values())
    if tf_files > len(tf):
        raise ValueError(f"tf_files={tf_files}: at most {len(tf)} fixtures a module")
    for i in range(tf_dirs):
        root = f"tf/stack{i:03d}"
        files[f"{root}/main.tf"] = TF_ROOT
        files[f"{root}/variables.tf"] = TF_VARIABLES
        files[f"{root}/terraform.tfvars"] = f"encrypt = {'false' if i % 2 == 0 else 'true'}\n"
        plant(f"{root}/modules/store/main.tf", TF_CHILD, TF_CHILD_CHECK, i % 2 == 0)
        for j in range(tf_files):
            cid, bad, good = tf[(i * tf_files + j) % len(tf)]
            fails = (i + j) % 2 == 0
            plant(f"{root}/f{j}.tf", bad if fails else good, cid, fails)
    k8s = list(K8S.values())
    for i in range(manifests):
        cid, bad, good = k8s[i % len(k8s)]
        path = f"k8s/app{i:03d}/manifest.yaml"
        if i % 5 == 4:
            plant(path, bad + "---\n" + good, cid, True)
        else:
            plant(path, bad if i % 2 == 0 else good, cid, i % 2 == 0)
    docker = list(DOCKER.values())
    for i in range(dockerfiles):
        cid, bad, good = docker[i % len(docker)]
        fails = (i // len(docker)) % 2 == 0
        plant(f"docker/svc{i:03d}/Dockerfile", bad if fails else good, cid, fails)
    cfn = list(CFN.values())
    for i in range(templates):
        cid, rtype, bad, good = cfn[i % len(cfn)]
        fails = (i // len(cfn)) % 2 == 0
        as_json = i % 3 == 0
        path = f"cfn/stack{i:03d}.{'json' if as_json else 'yaml'}"
        plant(path, cfn_template(rtype, bad if fails else good, as_json), cid, fails)
    for i in range(charts):
        root = f"helm/chart{i}"
        files[f"{root}/Chart.yaml"] = CHART_YAML.format(name=f"app{i}")
        files[f"{root}/values.yaml"] = VALUES_YAML.format(priv="true" if i % 2 == 0 else "false")
        files[f"{root}/templates/_helpers.tpl"] = HELPERS_TPL
        plant(f"{root}/templates/deployment.yaml", DEPLOYMENT_TPL, "KSV017", i % 2 == 0)
    arm = list(ARM.values())
    for i in range(configs // 2):
        cid, bad, good = arm[i % len(arm)]
        fails = (i // len(arm)) % 2 == 0
        plant(f"config/arm{i:03d}.json", arm_template(bad if fails else good), cid, fails)
        plant(f"config/settings{i:03d}.toml", f"telnet = {'true' if fails else 'false'}\n",
              TOML_CHECK_ID, fails)
    return {p: t.encode() for p, t in files.items()}, planted


# An image config whose history, rebuilt into a Dockerfile, fails DS002 (no
# USER), DS004 (EXPOSE 22), DS005 (ADD of a plain file), DS010 (sudo),
# DS021 (apt-get upgrade), DS022 (MAINTAINER) and DS026 (no HEALTHCHECK).
HISTORY_CHECKS = ("DS002", "DS004", "DS005", "DS010", "DS021", "DS022", "DS026")
IMAGE_HISTORY = [
    {"created_by": "/bin/sh -c #(nop) ADD file:4a7c5b2e in / "},
    {"created_by": "/bin/sh -c #(nop)  MAINTAINER dev@example.com"},
    {"created_by": "/bin/sh -c sudo apt-get update && apt-get -y upgrade"},
    {"created_by": "/bin/sh -c #(nop) ADD app.py /srv/app.py"},
    {"created_by": "/bin/sh -c #(nop)  EXPOSE 22"},
    {"created_by": '/bin/sh -c #(nop)  CMD ["python3", "/srv/app.py"]'},
]
