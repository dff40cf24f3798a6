# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: dataset.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rdataset.proto\x12\x11xpt_mde_tpu.waymo\"\x1b\n\x0bMatrixShape\x12\x0c\n\x04\x64ims\x18\x01 \x03(\x05\"N\n\x0bMatrixFloat\x12\x10\n\x04\x64\x61ta\x18\x01 \x03(\x02\x42\x02\x10\x01\x12-\n\x05shape\x18\x02 \x01(\x0b\x32\x1e.xpt_mde_tpu.waymo.MatrixShape\"N\n\x0bMatrixInt32\x12\x10\n\x04\x64\x61ta\x18\x01 \x03(\x05\x42\x02\x10\x01\x12-\n\x05shape\x18\x02 \x01(\x0b\x32\x1e.xpt_mde_tpu.waymo.MatrixShape\"l\n\nCameraName\"^\n\x04Name\x12\x0b\n\x07UNKNOWN\x10\x00\x12\t\n\x05\x46RONT\x10\x01\x12\x0e\n\nFRONT_LEFT\x10\x02\x12\x0f\n\x0b\x46RONT_RIGHT\x10\x03\x12\r\n\tSIDE_LEFT\x10\x04\x12\x0e\n\nSIDE_RIGHT\x10\x05\"]\n\tLaserName\"P\n\x04Name\x12\x0b\n\x07UNKNOWN\x10\x00\x12\x07\n\x03TOP\x10\x01\x12\t\n\x05\x46RONT\x10\x02\x12\r\n\tSIDE_LEFT\x10\x03\x12\x0e\n\nSIDE_RIGHT\x10\x04\x12\x08\n\x04REAR\x10\x05\"\x1e\n\tTransform\x12\x11\n\ttransform\x18\x01 \x03(\x01\"\xa8\x01\n\x11\x43\x61meraCalibration\x12\x30\n\x04name\x18\x01 \x01(\x0e\x32\".xpt_mde_tpu.waymo.CameraName.Name\x12\x11\n\tintrinsic\x18\x02 \x03(\x01\x12/\n\textrinsic\x18\x03 \x01(\x0b\x32\x1c.xpt_mde_tpu.waymo.Transform\x12\r\n\x05width\x18\x04 \x01(\x05\x12\x0e\n\x06height\x18\x05 \x01(\x05\"\xcb\x01\n\x10LaserCalibration\x12/\n\x04name\x18\x01 \x01(\x0e\x32!.xpt_mde_tpu.waymo.LaserName.Name\x12\x19\n\x11\x62\x65\x61m_inclinations\x18\x02 \x03(\x01\x12\x1c\n\x14\x62\x65\x61m_inclination_min\x18\x03 \x01(\x01\x12\x1c\n\x14\x62\x65\x61m_inclination_max\x18\x04 \x01(\x01\x12/\n\textrinsic\x18\x05 \x01(\x0b\x32\x1c.xpt_mde_tpu.waymo.Transform\"\x8d\x02\n\x07\x43ontext\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x41\n\x13\x63\x61mera_calibrations\x18\x02 \x03(\x0b\x32$.xpt_mde_tpu.waymo.CameraCalibration\x12?\n\x12laser_calibrations\x18\x03 \x03(\x0b\x32#.xpt_mde_tpu.waymo.LaserCalibration\x12/\n\x05stats\x18\x04 \x01(\x0b\x32 .xpt_mde_tpu.waymo.Context.Stats\x1a?\n\x05Stats\x12\x13\n\x0btime_of_day\x18\x02 \x01(\t\x12\x10\n\x08location\x18\x03 \x01(\t\x12\x0f\n\x07weather\x18\x04 \x01(\t\"\xac\x01\n\nRangeImage\x12\x1e\n\x16range_image_compressed\x18\x01 \x01(\x0c\x12$\n\x1c\x63\x61mera_projection_compressed\x18\x02 \x01(\x0c\x12#\n\x1brange_image_pose_compressed\x18\x03 \x01(\x0c\x12\x33\n\x0brange_image\x18\x04 \x01(\x0b\x32\x1e.xpt_mde_tpu.waymo.MatrixFloat\"z\n\x0b\x43\x61meraImage\x12\x30\n\x04name\x18\x01 \x01(\x0e\x32\".xpt_mde_tpu.waymo.CameraName.Name\x12\r\n\x05image\x18\x02 \x01(\x0c\x12*\n\x04pose\x18\x03 \x01(\x0b\x32\x1c.xpt_mde_tpu.waymo.Transform\"\x9e\x01\n\x05Laser\x12/\n\x04name\x18\x01 \x01(\x0e\x32!.xpt_mde_tpu.waymo.LaserName.Name\x12\x31\n\nri_return1\x18\x02 \x01(\x0b\x32\x1d.xpt_mde_tpu.waymo.RangeImage\x12\x31\n\nri_return2\x18\x03 \x01(\x0b\x32\x1d.xpt_mde_tpu.waymo.RangeImage\"\xd4\x01\n\x05\x46rame\x12+\n\x07\x63ontext\x18\x01 \x01(\x0b\x32\x1a.xpt_mde_tpu.waymo.Context\x12\x18\n\x10timestamp_micros\x18\x02 \x01(\x03\x12*\n\x04pose\x18\x03 \x01(\x0b\x32\x1c.xpt_mde_tpu.waymo.Transform\x12.\n\x06images\x18\x04 \x03(\x0b\x32\x1e.xpt_mde_tpu.waymo.CameraImage\x12(\n\x06lasers\x18\x05 \x03(\x0b\x32\x18.xpt_mde_tpu.waymo.Laser')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'dataset_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _MATRIXFLOAT.fields_by_name['data']._options = None
  _MATRIXFLOAT.fields_by_name['data']._serialized_options = b'\020\001'
  _MATRIXINT32.fields_by_name['data']._options = None
  _MATRIXINT32.fields_by_name['data']._serialized_options = b'\020\001'
  _MATRIXSHAPE._serialized_start=36
  _MATRIXSHAPE._serialized_end=63
  _MATRIXFLOAT._serialized_start=65
  _MATRIXFLOAT._serialized_end=143
  _MATRIXINT32._serialized_start=145
  _MATRIXINT32._serialized_end=223
  _CAMERANAME._serialized_start=225
  _CAMERANAME._serialized_end=333
  _CAMERANAME_NAME._serialized_start=239
  _CAMERANAME_NAME._serialized_end=333
  _LASERNAME._serialized_start=335
  _LASERNAME._serialized_end=428
  _LASERNAME_NAME._serialized_start=348
  _LASERNAME_NAME._serialized_end=428
  _TRANSFORM._serialized_start=430
  _TRANSFORM._serialized_end=460
  _CAMERACALIBRATION._serialized_start=463
  _CAMERACALIBRATION._serialized_end=631
  _LASERCALIBRATION._serialized_start=634
  _LASERCALIBRATION._serialized_end=837
  _CONTEXT._serialized_start=840
  _CONTEXT._serialized_end=1109
  _CONTEXT_STATS._serialized_start=1046
  _CONTEXT_STATS._serialized_end=1109
  _RANGEIMAGE._serialized_start=1112
  _RANGEIMAGE._serialized_end=1284
  _CAMERAIMAGE._serialized_start=1286
  _CAMERAIMAGE._serialized_end=1408
  _LASER._serialized_start=1411
  _LASER._serialized_end=1569
  _FRAME._serialized_start=1572
  _FRAME._serialized_end=1784
# @@protoc_insertion_point(module_scope)
