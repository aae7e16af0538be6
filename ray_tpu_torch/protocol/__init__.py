"""Protobuf wire schema (raytpu.proto) + generated bindings.

Regenerate with:  protoc --python_out=. ray_tpu_torch/protocol/raytpu.proto
(from the REPO ROOT — the package-pathed module name makes generated
messages pickle by reference across worker processes).
The C++ frontend compiles the same schema with protoc --cpp_out.
"""
from ray_tpu_torch.protocol import raytpu_pb2  # noqa: F401
