# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: edgeric.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\redgeric.proto\x12\x0b\x65\x64geric_tpu\"\x8d\x01\n\tUeMetrics\x12\x0c\n\x04rnti\x18\x01 \x01(\r\x12\x0b\n\x03\x63qi\x18\x02 \x01(\r\x12\x0b\n\x03snr\x18\x03 \x01(\x02\x12\x10\n\x08tx_bytes\x18\x04 \x01(\x02\x12\x10\n\x08rx_bytes\x18\x05 \x01(\x02\x12\x11\n\tdl_buffer\x18\x06 \x01(\r\x12\x11\n\tul_buffer\x18\x07 \x01(\r\x12\x0e\n\x06\x64l_tbs\x18\x08 \x01(\x02\"F\n\x07Metrics\x12\x0f\n\x07tti_cnt\x18\x01 \x01(\r\x12*\n\nue_metrics\x18\x02 \x03(\x0b\x32\x16.edgeric_tpu.UeMetrics\"7\n\x11SchedulingWeights\x12\x11\n\tran_index\x18\x01 \x01(\r\x12\x0f\n\x07weights\x18\x02 \x03(\x02\",\n\nMcsControl\x12\x11\n\tran_index\x18\x01 \x01(\r\x12\x0b\n\x03mcs\x18\x02 \x03(\x02\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'edgeric_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _UEMETRICS._serialized_start=31
  _UEMETRICS._serialized_end=172
  _METRICS._serialized_start=174
  _METRICS._serialized_end=244
  _SCHEDULINGWEIGHTS._serialized_start=246
  _SCHEDULINGWEIGHTS._serialized_end=301
  _MCSCONTROL._serialized_start=303
  _MCSCONTROL._serialized_end=347
# @@protoc_insertion_point(module_scope)
