# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: nri.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\tnri.proto\x12\x0fnri.pb.v1alpha1\"\x07\n\x05\x45mpty\"@\n\x15RegisterPluginRequest\x12\x13\n\x0bplugin_name\x18\x01 \x01(\t\x12\x12\n\nplugin_idx\x18\x02 \x01(\t\"\x88\x01\n\x10\x43onfigureRequest\x12\x0e\n\x06\x63onfig\x18\x01 \x01(\t\x12\x14\n\x0cruntime_name\x18\x02 \x01(\t\x12\x17\n\x0fruntime_version\x18\x03 \x01(\t\x12\x1c\n\x14registration_timeout\x18\x04 \x01(\x03\x12\x17\n\x0frequest_timeout\x18\x05 \x01(\x03\"#\n\x11\x43onfigureResponse\x12\x0e\n\x06\x65vents\x18\x01 \x01(\x05\"}\n\x12SynchronizeRequest\x12)\n\x04pods\x18\x01 \x03(\x0b\x32\x1b.nri.pb.v1alpha1.PodSandbox\x12.\n\ncontainers\x18\x02 \x03(\x0b\x32\x1a.nri.pb.v1alpha1.Container\x12\x0c\n\x04more\x18\x03 \x01(\x08\"U\n\x13SynchronizeResponse\x12\x30\n\x06update\x18\x01 \x03(\x0b\x32 .nri.pb.v1alpha1.ContainerUpdate\x12\x0c\n\x04more\x18\x02 \x01(\x08\"\x92\x01\n\x10StateChangeEvent\x12%\n\x05\x65vent\x18\x01 \x01(\x0e\x32\x16.nri.pb.v1alpha1.Event\x12(\n\x03pod\x18\x02 \x01(\x0b\x32\x1b.nri.pb.v1alpha1.PodSandbox\x12-\n\tcontainer\x18\x03 \x01(\x0b\x32\x1a.nri.pb.v1alpha1.Container\"q\n\x16\x43reateContainerRequest\x12(\n\x03pod\x18\x01 \x01(\x0b\x32\x1b.nri.pb.v1alpha1.PodSandbox\x12-\n\tcontainer\x18\x02 \x01(\x0b\x32\x1a.nri.pb.v1alpha1.Container\"\xb4\x01\n\x17\x43reateContainerResponse\x12\x34\n\x06\x61\x64just\x18\x01 \x01(\x0b\x32$.nri.pb.v1alpha1.ContainerAdjustment\x12\x30\n\x06update\x18\x02 \x03(\x0b\x32 .nri.pb.v1alpha1.ContainerUpdate\x12\x31\n\x05\x65vict\x18\x03 \x03(\x0b\x32\".nri.pb.v1alpha1.ContainerEviction\"\xab\x01\n\x16UpdateContainerRequest\x12(\n\x03pod\x18\x01 \x01(\x0b\x32\x1b.nri.pb.v1alpha1.PodSandbox\x12-\n\tcontainer\x18\x02 \x01(\x0b\x32\x1a.nri.pb.v1alpha1.Container\x12\x38\n\x0flinux_resources\x18\x03 \x01(\x0b\x32\x1f.nri.pb.v1alpha1.LinuxResources\"K\n\x17UpdateContainerResponse\x12\x30\n\x06update\x18\x01 \x03(\x0b\x32 .nri.pb.v1alpha1.ContainerUpdate\"o\n\x14StopContainerRequest\x12(\n\x03pod\x18\x01 \x01(\x0b\x32\x1b.nri.pb.v1alpha1.PodSandbox\x12-\n\tcontainer\x18\x02 \x01(\x0b\x32\x1a.nri.pb.v1alpha1.Container\"I\n\x15StopContainerResponse\x12\x30\n\x06update\x18\x01 \x03(\x0b\x32 .nri.pb.v1alpha1.ContainerUpdate\"~\n\x17UpdateContainersRequest\x12\x30\n\x06update\x18\x01 \x03(\x0b\x32 .nri.pb.v1alpha1.ContainerUpdate\x12\x31\n\x05\x65vict\x18\x02 \x03(\x0b\x32\".nri.pb.v1alpha1.ContainerEviction\"L\n\x18UpdateContainersResponse\x12\x30\n\x06\x66\x61iled\x18\x01 \x03(\x0b\x32 .nri.pb.v1alpha1.ContainerUpdate\"\xbe\x02\n\nPodSandbox\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x0b\n\x03uid\x18\x03 \x01(\t\x12\x11\n\tnamespace\x18\x04 \x01(\t\x12\x37\n\x06labels\x18\x05 \x03(\x0b\x32\'.nri.pb.v1alpha1.PodSandbox.LabelsEntry\x12\x41\n\x0b\x61nnotations\x18\x06 \x03(\x0b\x32,.nri.pb.v1alpha1.PodSandbox.AnnotationsEntry\x12\x17\n\x0fruntime_handler\x18\x07 \x01(\t\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\xca\x03\n\tContainer\x12\n\n\x02id\x18\x01 \x01(\t\x12\x16\n\x0epod_sandbox_id\x18\x02 \x01(\t\x12\x0c\n\x04name\x18\x03 \x01(\t\x12.\n\x05state\x18\x04 \x01(\x0e\x32\x1f.nri.pb.v1alpha1.ContainerState\x12\x36\n\x06labels\x18\x05 \x03(\x0b\x32&.nri.pb.v1alpha1.Container.LabelsEntry\x12@\n\x0b\x61nnotations\x18\x06 \x03(\x0b\x32+.nri.pb.v1alpha1.Container.AnnotationsEntry\x12\x0c\n\x04\x61rgs\x18\x07 \x03(\t\x12\x0b\n\x03\x65nv\x18\x08 \x03(\t\x12&\n\x06mounts\x18\t \x03(\x0b\x32\x16.nri.pb.v1alpha1.Mount\x12.\n\x05linux\x18\x0b \x01(\x0b\x32\x1f.nri.pb.v1alpha1.LinuxContainer\x12\x0b\n\x03pid\x18\x0c \x01(\r\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"s\n\x0eLinuxContainer\x12-\n\x07\x64\x65vices\x18\x02 \x03(\x0b\x32\x1c.nri.pb.v1alpha1.LinuxDevice\x12\x32\n\tresources\x18\x03 \x01(\x0b\x32\x1f.nri.pb.v1alpha1.LinuxResources\"K\n\x05Mount\x12\x13\n\x0b\x64\x65stination\x18\x01 \x01(\t\x12\x0c\n\x04type\x18\x02 \x01(\t\x12\x0e\n\x06source\x18\x03 \x01(\t\x12\x0f\n\x07options\x18\x04 \x03(\t\"&\n\x08KeyValue\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\"\x1f\n\x0eOptionalString\x12\r\n\x05value\x18\x01 \x01(\t\"\x1e\n\rOptionalInt64\x12\r\n\x05value\x18\x01 \x01(\x03\"\x1f\n\x0eOptionalUInt32\x12\r\n\x05value\x18\x01 \x01(\r\"!\n\x10OptionalFileMode\x12\r\n\x05value\x18\x01 \x01(\r\"\xd9\x01\n\x0bLinuxDevice\x12\x0c\n\x04path\x18\x01 \x01(\t\x12\x0c\n\x04type\x18\x02 \x01(\t\x12\r\n\x05major\x18\x03 \x01(\x03\x12\r\n\x05minor\x18\x04 \x01(\x03\x12\x34\n\tfile_mode\x18\x05 \x01(\x0b\x32!.nri.pb.v1alpha1.OptionalFileMode\x12,\n\x03uid\x18\x06 \x01(\x0b\x32\x1f.nri.pb.v1alpha1.OptionalUInt32\x12,\n\x03gid\x18\x07 \x01(\x0b\x32\x1f.nri.pb.v1alpha1.OptionalUInt32\"f\n\x0eLinuxResources\x12,\n\x06memory\x18\x01 \x01(\x0b\x32\x1c.nri.pb.v1alpha1.LinuxMemory\x12&\n\x03\x63pu\x18\x02 \x01(\x0b\x32\x19.nri.pb.v1alpha1.LinuxCPU\"<\n\x0bLinuxMemory\x12-\n\x05limit\x18\x01 \x01(\x0b\x32\x1e.nri.pb.v1alpha1.OptionalInt64\"9\n\x08LinuxCPU\x12-\n\x04\x63pus\x18\x05 \x01(\x0b\x32\x1f.nri.pb.v1alpha1.OptionalString\"\x9f\x02\n\x13\x43ontainerAdjustment\x12J\n\x0b\x61nnotations\x18\x02 \x03(\x0b\x32\x35.nri.pb.v1alpha1.ContainerAdjustment.AnnotationsEntry\x12&\n\x06mounts\x18\x03 \x03(\x0b\x32\x16.nri.pb.v1alpha1.Mount\x12&\n\x03\x65nv\x18\x04 \x03(\x0b\x32\x19.nri.pb.v1alpha1.KeyValue\x12\x38\n\x05linux\x18\x06 \x01(\x0b\x32).nri.pb.v1alpha1.LinuxContainerAdjustment\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\x93\x01\n\x18LinuxContainerAdjustment\x12-\n\x07\x64\x65vices\x18\x01 \x03(\x0b\x32\x1c.nri.pb.v1alpha1.LinuxDevice\x12\x32\n\tresources\x18\x02 \x01(\x0b\x32\x1f.nri.pb.v1alpha1.LinuxResources\x12\x14\n\x0c\x63groups_path\x18\x03 \x01(\t\"u\n\x0f\x43ontainerUpdate\x12\x14\n\x0c\x63ontainer_id\x18\x01 \x01(\t\x12\x34\n\x05linux\x18\x02 \x01(\x0b\x32%.nri.pb.v1alpha1.LinuxContainerUpdate\x12\x16\n\x0eignore_failure\x18\x03 \x01(\x08\"J\n\x14LinuxContainerUpdate\x12\x32\n\tresources\x18\x01 \x01(\x0b\x32\x1f.nri.pb.v1alpha1.LinuxResources\"9\n\x11\x43ontainerEviction\x12\x14\n\x0c\x63ontainer_id\x18\x01 \x01(\t\x12\x0e\n\x06reason\x18\x02 \x01(\t*\x9c\x02\n\x05\x45vent\x12\x0b\n\x07UNKNOWN\x10\x00\x12\x13\n\x0fRUN_POD_SANDBOX\x10\x01\x12\x14\n\x10STOP_POD_SANDBOX\x10\x02\x12\x16\n\x12REMOVE_POD_SANDBOX\x10\x03\x12\x14\n\x10\x43REATE_CONTAINER\x10\x04\x12\x19\n\x15POST_CREATE_CONTAINER\x10\x05\x12\x13\n\x0fSTART_CONTAINER\x10\x06\x12\x18\n\x14POST_START_CONTAINER\x10\x07\x12\x14\n\x10UPDATE_CONTAINER\x10\x08\x12\x19\n\x15POST_UPDATE_CONTAINER\x10\t\x12\x12\n\x0eSTOP_CONTAINER\x10\n\x12\x14\n\x10REMOVE_CONTAINER\x10\x0b\x12\x08\n\x04LAST\x10\x0c*\x82\x01\n\x0e\x43ontainerState\x12\x15\n\x11\x43ONTAINER_UNKNOWN\x10\x00\x12\x15\n\x11\x43ONTAINER_CREATED\x10\x01\x12\x14\n\x10\x43ONTAINER_PAUSED\x10\x02\x12\x15\n\x11\x43ONTAINER_RUNNING\x10\x03\x12\x15\n\x11\x43ONTAINER_STOPPED\x10\x04\x32\xc4\x01\n\x07Runtime\x12P\n\x0eRegisterPlugin\x12&.nri.pb.v1alpha1.RegisterPluginRequest\x1a\x16.nri.pb.v1alpha1.Empty\x12g\n\x10UpdateContainers\x12(.nri.pb.v1alpha1.UpdateContainersRequest\x1a).nri.pb.v1alpha1.UpdateContainersResponse2\xe8\x04\n\x06Plugin\x12R\n\tConfigure\x12!.nri.pb.v1alpha1.ConfigureRequest\x1a\".nri.pb.v1alpha1.ConfigureResponse\x12X\n\x0bSynchronize\x12#.nri.pb.v1alpha1.SynchronizeRequest\x1a$.nri.pb.v1alpha1.SynchronizeResponse\x12:\n\x08Shutdown\x12\x16.nri.pb.v1alpha1.Empty\x1a\x16.nri.pb.v1alpha1.Empty\x12\x64\n\x0f\x43reateContainer\x12\'.nri.pb.v1alpha1.CreateContainerRequest\x1a(.nri.pb.v1alpha1.CreateContainerResponse\x12\x64\n\x0fUpdateContainer\x12\'.nri.pb.v1alpha1.UpdateContainerRequest\x1a(.nri.pb.v1alpha1.UpdateContainerResponse\x12^\n\rStopContainer\x12%.nri.pb.v1alpha1.StopContainerRequest\x1a&.nri.pb.v1alpha1.StopContainerResponse\x12H\n\x0bStateChange\x12!.nri.pb.v1alpha1.StateChangeEvent\x1a\x16.nri.pb.v1alpha1.Emptyb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'nri_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PODSANDBOX_LABELSENTRY._options = None
  _PODSANDBOX_LABELSENTRY._serialized_options = b'8\001'
  _PODSANDBOX_ANNOTATIONSENTRY._options = None
  _PODSANDBOX_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _CONTAINER_LABELSENTRY._options = None
  _CONTAINER_LABELSENTRY._serialized_options = b'8\001'
  _CONTAINER_ANNOTATIONSENTRY._options = None
  _CONTAINER_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _CONTAINERADJUSTMENT_ANNOTATIONSENTRY._options = None
  _CONTAINERADJUSTMENT_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _EVENT._serialized_start=3876
  _EVENT._serialized_end=4160
  _CONTAINERSTATE._serialized_start=4163
  _CONTAINERSTATE._serialized_end=4293
  _EMPTY._serialized_start=30
  _EMPTY._serialized_end=37
  _REGISTERPLUGINREQUEST._serialized_start=39
  _REGISTERPLUGINREQUEST._serialized_end=103
  _CONFIGUREREQUEST._serialized_start=106
  _CONFIGUREREQUEST._serialized_end=242
  _CONFIGURERESPONSE._serialized_start=244
  _CONFIGURERESPONSE._serialized_end=279
  _SYNCHRONIZEREQUEST._serialized_start=281
  _SYNCHRONIZEREQUEST._serialized_end=406
  _SYNCHRONIZERESPONSE._serialized_start=408
  _SYNCHRONIZERESPONSE._serialized_end=493
  _STATECHANGEEVENT._serialized_start=496
  _STATECHANGEEVENT._serialized_end=642
  _CREATECONTAINERREQUEST._serialized_start=644
  _CREATECONTAINERREQUEST._serialized_end=757
  _CREATECONTAINERRESPONSE._serialized_start=760
  _CREATECONTAINERRESPONSE._serialized_end=940
  _UPDATECONTAINERREQUEST._serialized_start=943
  _UPDATECONTAINERREQUEST._serialized_end=1114
  _UPDATECONTAINERRESPONSE._serialized_start=1116
  _UPDATECONTAINERRESPONSE._serialized_end=1191
  _STOPCONTAINERREQUEST._serialized_start=1193
  _STOPCONTAINERREQUEST._serialized_end=1304
  _STOPCONTAINERRESPONSE._serialized_start=1306
  _STOPCONTAINERRESPONSE._serialized_end=1379
  _UPDATECONTAINERSREQUEST._serialized_start=1381
  _UPDATECONTAINERSREQUEST._serialized_end=1507
  _UPDATECONTAINERSRESPONSE._serialized_start=1509
  _UPDATECONTAINERSRESPONSE._serialized_end=1585
  _PODSANDBOX._serialized_start=1588
  _PODSANDBOX._serialized_end=1906
  _PODSANDBOX_LABELSENTRY._serialized_start=1809
  _PODSANDBOX_LABELSENTRY._serialized_end=1854
  _PODSANDBOX_ANNOTATIONSENTRY._serialized_start=1856
  _PODSANDBOX_ANNOTATIONSENTRY._serialized_end=1906
  _CONTAINER._serialized_start=1909
  _CONTAINER._serialized_end=2367
  _CONTAINER_LABELSENTRY._serialized_start=1809
  _CONTAINER_LABELSENTRY._serialized_end=1854
  _CONTAINER_ANNOTATIONSENTRY._serialized_start=1856
  _CONTAINER_ANNOTATIONSENTRY._serialized_end=1906
  _LINUXCONTAINER._serialized_start=2369
  _LINUXCONTAINER._serialized_end=2484
  _MOUNT._serialized_start=2486
  _MOUNT._serialized_end=2561
  _KEYVALUE._serialized_start=2563
  _KEYVALUE._serialized_end=2601
  _OPTIONALSTRING._serialized_start=2603
  _OPTIONALSTRING._serialized_end=2634
  _OPTIONALINT64._serialized_start=2636
  _OPTIONALINT64._serialized_end=2666
  _OPTIONALUINT32._serialized_start=2668
  _OPTIONALUINT32._serialized_end=2699
  _OPTIONALFILEMODE._serialized_start=2701
  _OPTIONALFILEMODE._serialized_end=2734
  _LINUXDEVICE._serialized_start=2737
  _LINUXDEVICE._serialized_end=2954
  _LINUXRESOURCES._serialized_start=2956
  _LINUXRESOURCES._serialized_end=3058
  _LINUXMEMORY._serialized_start=3060
  _LINUXMEMORY._serialized_end=3120
  _LINUXCPU._serialized_start=3122
  _LINUXCPU._serialized_end=3179
  _CONTAINERADJUSTMENT._serialized_start=3182
  _CONTAINERADJUSTMENT._serialized_end=3469
  _CONTAINERADJUSTMENT_ANNOTATIONSENTRY._serialized_start=1856
  _CONTAINERADJUSTMENT_ANNOTATIONSENTRY._serialized_end=1906
  _LINUXCONTAINERADJUSTMENT._serialized_start=3472
  _LINUXCONTAINERADJUSTMENT._serialized_end=3619
  _CONTAINERUPDATE._serialized_start=3621
  _CONTAINERUPDATE._serialized_end=3738
  _LINUXCONTAINERUPDATE._serialized_start=3740
  _LINUXCONTAINERUPDATE._serialized_end=3814
  _CONTAINEREVICTION._serialized_start=3816
  _CONTAINEREVICTION._serialized_end=3873
  _RUNTIME._serialized_start=4296
  _RUNTIME._serialized_end=4492
  _PLUGIN._serialized_start=4495
  _PLUGIN._serialized_end=5111
# @@protoc_insertion_point(module_scope)
