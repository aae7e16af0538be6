# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: ray_tpu_torch/protocol/raytpu.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n#ray_tpu_torch/protocol/raytpu.proto\x12\x0craytpu_torch\"%\n\x05Value\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\x12\x0e\n\x06\x66ormat\x18\x02 \x01(\t\"G\n\x03\x41rg\x12$\n\x05value\x18\x01 \x01(\x0b\x32\x13.raytpu_torch.ValueH\x00\x12\x13\n\tobject_id\x18\x02 \x01(\x0cH\x00\x42\x05\n\x03\x61rg\"\xa1\x01\n\x08TaskArgs\x12\x1f\n\x04\x61rgs\x18\x01 \x03(\x0b\x32\x11.raytpu_torch.Arg\x12\x32\n\x06kwargs\x18\x02 \x03(\x0b\x32\".raytpu_torch.TaskArgs.KwargsEntry\x1a@\n\x0bKwargsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12 \n\x05value\x18\x02 \x01(\x0b\x32\x11.raytpu_torch.Arg:\x02\x38\x01\"\xc6\x04\n\x08TaskSpec\x12\x0f\n\x07task_id\x18\x01 \x01(\x0c\x12\r\n\x05\x66n_id\x18\x02 \x01(\x0c\x12\x0c\n\x04name\x18\x03 \x01(\t\x12$\n\x07payload\x18\x04 \x01(\x0b\x32\x13.raytpu_torch.Value\x12\x12\n\nreturn_ids\x18\x05 \x03(\x0c\x12\x10\n\x08num_cpus\x18\x06 \x01(\x01\x12\x10\n\x08num_gpus\x18\x07 \x01(\x01\x12\x38\n\tresources\x18\x08 \x03(\x0b\x32%.raytpu_torch.TaskSpec.ResourcesEntry\x12\x13\n\x0bmax_retries\x18\t \x01(\x05\x12\x14\n\x0cretries_left\x18\n \x01(\x05\x12\x10\n\x08\x61\x63tor_id\x18\x0b \x01(\x0c\x12\x13\n\x0bmethod_name\x18\x0c \x01(\t\x12\x0e\n\x06seq_no\x18\r \x01(\x03\x12\r\n\x05owner\x18\x0e \x01(\x0c\x12\x14\n\x0c\x64\x65pendencies\x18\x0f \x03(\x0c\x12(\n\x0bruntime_env\x18\x10 \x01(\x0b\x32\x13.raytpu_torch.Value\x12\x30\n\x13scheduling_strategy\x18\x11 \x01(\x0b\x32\x13.raytpu_torch.Value\x12\x11\n\tstreaming\x18\x12 \x01(\x08\x12\x12\n\ncaller_seq\x18\x13 \x01(\x03\x12\x16\n\x0ehas_caller_seq\x18\x14 \x01(\x08\x12\x10\n\x08language\x18\x15 \x01(\t\x12\x0e\n\x06job_id\x18\x16 \x01(\t\x1a\x30\n\x0eResourcesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01:\x02\x38\x01\"\xc3\x04\n\x11\x41\x63torCreationSpec\x12\x10\n\x08\x61\x63tor_id\x18\x01 \x01(\x0c\x12\x0e\n\x06\x63ls_id\x18\x02 \x01(\x0c\x12\x0c\n\x04name\x18\x03 \x01(\t\x12$\n\x07payload\x18\x04 \x01(\x0b\x32\x13.raytpu_torch.Value\x12\x14\n\x0cmax_restarts\x18\x05 \x01(\x05\x12\x15\n\rrestarts_used\x18\x06 \x01(\x05\x12\x18\n\x10max_task_retries\x18\x07 \x01(\x05\x12\x17\n\x0fmax_concurrency\x18\x08 \x01(\x05\x12\x10\n\x08is_async\x18\t \x01(\x08\x12\x10\n\x08num_cpus\x18\n \x01(\x01\x12\x10\n\x08num_gpus\x18\x0b \x01(\x01\x12\x41\n\tresources\x18\x0c \x03(\x0b\x32..raytpu_torch.ActorCreationSpec.ResourcesEntry\x12\x1a\n\x12placement_group_id\x18\r \x01(\x0c\x12\x14\n\x0c\x62undle_index\x18\x0e \x01(\x05\x12(\n\x0bruntime_env\x18\x0f \x01(\x0b\x32\x13.raytpu_torch.Value\x12\x14\n\x0c\x64\x65pendencies\x18\x10 \x03(\x0c\x12)\n\x0cmethods_meta\x18\x11 \x01(\x0b\x32\x13.raytpu_torch.Value\x12\x30\n\x13scheduling_strategy\x18\x12 \x01(\x0b\x32\x13.raytpu_torch.Value\x1a\x30\n\x0eResourcesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01:\x02\x38\x01\"\xae\x03\n\x0cRegisterNode\x12\x0f\n\x07node_id\x18\x01 \x01(\x0c\x12<\n\tresources\x18\x02 \x03(\x0b\x32).raytpu_torch.RegisterNode.ResourcesEntry\x12\x11\n\tpeer_host\x18\x03 \x01(\t\x12\x11\n\tpeer_port\x18\x04 \x01(\x05\x12\x10\n\x08hostname\x18\x05 \x01(\t\x12\x0b\n\x03pid\x18\x06 \x01(\x03\x12=\n\tinventory\x18\x07 \x03(\x0b\x32*.raytpu_torch.RegisterNode.WorkerInventory\x12\x11\n\tctrl_host\x18\x08 \x01(\t\x12\x11\n\tctrl_port\x18\t \x01(\x05\x12\x18\n\x10object_inventory\x18\n \x03(\x0c\x1a\x30\n\x0eResourcesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01:\x02\x38\x01\x1aY\n\x0fWorkerInventory\x12\x11\n\tworker_id\x18\x01 \x01(\x0c\x12\x10\n\x08\x61\x63tor_id\x18\x02 \x01(\x0c\x12\x0f\n\x07\x65nv_key\x18\x03 \x01(\t\x12\x10\n\x08language\x18\x04 \x01(\t\"w\n\tHeartbeat\x12\x0f\n\x07node_id\x18\x01 \x01(\x0c\x12\x14\n\x0cview_version\x18\x02 \x01(\x03\x12\x14\n\x0cidle_workers\x18\x03 \x01(\x05\x12\x15\n\rlease_backlog\x18\x04 \x01(\x05\x12\x16\n\x0elease_inflight\x18\x05 \x01(\x05\"\xc1\x01\n\x10\x43lusterViewEntry\x12\x0f\n\x07node_id\x18\x01 \x01(\x0c\x12\x15\n\rentry_version\x18\x02 \x01(\x03\x12\r\n\x05state\x18\x03 \x01(\t\x12\x14\n\x0cidle_workers\x18\x04 \x01(\x05\x12\x15\n\rlease_backlog\x18\x05 \x01(\x05\x12\x16\n\x0elease_inflight\x18\x06 \x01(\x05\x12\x0b\n\x03\x63pu\x18\x07 \x01(\x01\x12\x11\n\tctrl_host\x18\x08 \x01(\t\x12\x11\n\tctrl_port\x18\t \x01(\x05\"O\n\x0b\x43lusterView\x12\x0f\n\x07version\x18\x01 \x01(\x03\x12/\n\x07\x65ntries\x18\x02 \x03(\x0b\x32\x1e.raytpu_torch.ClusterViewEntry\"\x92\x01\n\x0cLeaseSpilled\x12.\n\x05moves\x18\x01 \x03(\x0b\x32\x1f.raytpu_torch.LeaseSpilled.Move\x1aR\n\x04Move\x12\x0f\n\x07task_id\x18\x01 \x01(\x0c\x12\x11\n\tlease_seq\x18\x02 \x01(\x03\x12\x12\n\nspill_hops\x18\x03 \x01(\x03\x12\x12\n\nto_node_id\x18\x04 \x01(\x0c\"y\n\tTaskEvent\x12\x0f\n\x07task_id\x18\x01 \x01(\x0c\x12\x0f\n\x07\x61ttempt\x18\x02 \x01(\x03\x12\r\n\x05state\x18\x03 \x01(\t\x12\n\n\x02ts\x18\x04 \x01(\x01\x12\x0c\n\x04name\x18\x05 \x01(\t\x12!\n\x04\x64\x61ta\x18\x06 \x01(\x0b\x32\x13.raytpu_torch.Value\"F\n\nTaskEvents\x12\'\n\x06\x65vents\x18\x01 \x03(\x0b\x32\x17.raytpu_torch.TaskEvent\x12\x0f\n\x07\x64ropped\x18\x02 \x01(\x03\"\xb6\x01\n\rMetricsUpdate\x12\x33\n\x07metrics\x18\x01 \x03(\x0b\x32\".raytpu_torch.MetricsUpdate.Metric\x1ap\n\x06Metric\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0c\n\x04kind\x18\x02 \x01(\t\x12\x13\n\x0b\x64\x65scription\x18\x03 \x01(\t\x12\x10\n\x08tag_keys\x18\x04 \x03(\t\x12#\n\x06values\x18\x05 \x01(\x0b\x32\x13.raytpu_torch.Value\"7\n\x0f\x44irectActorCall\x12$\n\x04spec\x18\x01 \x01(\x0b\x32\x16.raytpu_torch.TaskSpec\"\x86\x01\n\x10\x44irectActorReply\x12\x32\n\x05\x64ones\x18\x01 \x03(\x0b\x32#.raytpu_torch.DirectActorReply.Done\x1a>\n\x04\x44one\x12\x0f\n\x07task_id\x18\x01 \x01(\x0c\x12%\n\x04outs\x18\x02 \x03(\x0b\x32\x17.raytpu_torch.WorkerOut\"\x1e\n\nShardHello\x12\x10\n\x08shard_id\x18\x01 \x01(\x05\"<\n\nShardReady\x12\x10\n\x08shard_id\x18\x01 \x01(\x05\x12\r\n\x05n_dir\x18\x02 \x01(\x03\x12\r\n\x05n_tev\x18\x03 \x01(\x03\"-\n\x0bShardAssign\x12\r\n\x05\x65poch\x18\x01 \x01(\x03\x12\x0f\n\x07\x62uckets\x18\x02 \x03(\x05\"l\n\x0bShardDirAdd\x12\x30\n\x07\x65ntries\x18\x01 \x03(\x0b\x32\x1f.raytpu_torch.ShardDirAdd.Entry\x1a+\n\x05\x45ntry\x12\x11\n\tobject_id\x18\x01 \x01(\x0c\x12\x0f\n\x07node_id\x18\x02 \x01(\x0c\"\"\n\x0cShardDirDrop\x12\x12\n\nobject_ids\x18\x01 \x03(\x0c\"[\n\x0eShardTevIngest\x12\x0f\n\x07node_id\x18\x01 \x01(\x0c\x12\'\n\x06\x65vents\x18\x02 \x03(\x0b\x32\x17.raytpu_torch.TaskEvent\x12\x0f\n\x07\x64ropped\x18\x03 \x01(\x03\"\x1f\n\rShardTevDrain\x12\x0e\n\x06req_id\x18\x01 \x01(\x03\"E\n\rShardTevBatch\x12\x0e\n\x06req_id\x18\x01 \x01(\x03\x12$\n\x07\x62\x61tches\x18\x02 \x01(\x0b\x32\x13.raytpu_torch.Value\"\x1f\n\rShardSnapshot\x12\x0e\n\x06req_id\x18\x01 \x01(\x03\"h\n\nShardState\x12\x0e\n\x06req_id\x18\x01 \x01(\x03\x12\r\n\x05\x65poch\x18\x02 \x01(\x03\x12&\n\tdirectory\x18\x03 \x01(\x0b\x32\x13.raytpu_torch.Value\x12\x13\n\x0btev_pending\x18\x04 \x01(\x03\"\x0f\n\rShardShutdown\"\x1f\n\x07NodeAck\x12\x14\n\x0chead_node_id\x18\x01 \x01(\x0c\" \n\x0bWorkerDeath\x12\x11\n\tworker_id\x18\x01 \x01(\x0c\"/\n\x0bSpawnWorker\x12 \n\x03pip\x18\x01 \x01(\x0b\x32\x13.raytpu_torch.Value\"\x1f\n\nKillWorker\x12\x11\n\tworker_id\x18\x01 \x01(\x0c\"U\n\x0b\x46\x65tchObject\x12\x11\n\tobject_id\x18\x01 \x01(\x0c\x12\x10\n\x08src_host\x18\x02 \x01(\t\x12\x10\n\x08src_port\x18\x03 \x01(\x05\x12\x0f\n\x07\x61ttempt\x18\x04 \x01(\x03\"?\n\rObjectFetched\x12\x11\n\tobject_id\x18\x01 \x01(\x0c\x12\n\n\x02ok\x18\x02 \x01(\x08\x12\x0f\n\x07\x61ttempt\x18\x03 \x01(\x03\"\x1f\n\nFreeObject\x12\x11\n\tobject_id\x18\x01 \x01(\x0c\"7\n\x07SeqSkip\x12\r\n\x05owner\x18\x01 \x01(\x0c\x12\x10\n\x08\x61\x63tor_id\x18\x02 \x01(\x0c\x12\x0b\n\x03seq\x18\x03 \x01(\x03\"\xc0\x05\n\nAgentFrame\x12\x33\n\rregister_node\x18\x01 \x01(\x0b\x32\x1a.raytpu_torch.RegisterNodeH\x00\x12,\n\theartbeat\x18\x02 \x01(\x0b\x32\x17.raytpu_torch.HeartbeatH\x00\x12)\n\x08node_ack\x18\x03 \x01(\x0b\x32\x15.raytpu_torch.NodeAckH\x00\x12\x31\n\x0cworker_death\x18\x04 \x01(\x0b\x32\x19.raytpu_torch.WorkerDeathH\x00\x12\x31\n\x0cspawn_worker\x18\x05 \x01(\x0b\x32\x19.raytpu_torch.SpawnWorkerH\x00\x12/\n\x0bkill_worker\x18\x06 \x01(\x0b\x32\x18.raytpu_torch.KillWorkerH\x00\x12*\n\x05\x66\x65tch\x18\x07 \x01(\x0b\x32\x19.raytpu_torch.FetchObjectH\x00\x12.\n\x07\x66\x65tched\x18\x08 \x01(\x0b\x32\x1b.raytpu_torch.ObjectFetchedH\x00\x12/\n\x0b\x66ree_object\x18\t \x01(\x0b\x32\x18.raytpu_torch.FreeObjectH\x00\x12)\n\x08seq_skip\x18\n \x01(\x0b\x32\x15.raytpu_torch.SeqSkipH\x00\x12\x31\n\x0c\x63luster_view\x18\x0b \x01(\x0b\x32\x19.raytpu_torch.ClusterViewH\x00\x12\x33\n\rlease_spilled\x18\x0c \x01(\x0b\x32\x1a.raytpu_torch.LeaseSpilledH\x00\x12/\n\x0btask_events\x18\r \x01(\x0b\x32\x18.raytpu_torch.TaskEventsH\x00\x12\x35\n\x0emetrics_update\x18\x0e \x01(\x0b\x32\x1b.raytpu_torch.MetricsUpdateH\x00\x42\x05\n\x03msg\"P\n\x0bWorkerHello\x12\x11\n\tworker_id\x18\x01 \x01(\x0c\x12\x0b\n\x03pid\x18\x02 \x01(\x03\x12\x10\n\x08language\x18\x03 \x01(\t\x12\x0f\n\x07symbols\x18\x04 \x03(\t\"2\n\nWorkerExec\x12$\n\x04spec\x18\x01 \x01(\x0b\x32\x16.raytpu_torch.TaskSpec\"R\n\tWorkerOut\x12\x11\n\tobject_id\x18\x01 \x01(\x0c\x12\x0e\n\x06status\x18\x02 \x01(\t\x12\"\n\x05\x65rror\x18\x03 \x01(\x0b\x32\x13.raytpu_torch.Value\"\x9e\x01\n\nWorkerDone\x12\x0f\n\x07task_id\x18\x01 \x01(\x0c\x12%\n\x04outs\x18\x02 \x03(\x0b\x32\x17.raytpu_torch.WorkerOut\x12\x0f\n\x07\x61ttempt\x18\x03 \x01(\x03\x12\x12\n\nexec_start\x18\x04 \x01(\x01\x12\x12\n\nargs_ready\x18\x05 \x01(\x01\x12\x11\n\texec_done\x18\x06 \x01(\x01\x12\x0c\n\x04seal\x18\x07 \x01(\x01\"\x10\n\x0eWorkerShutdown\"\xc6\x01\n\x0bWorkerFrame\x12*\n\x05hello\x18\x01 \x01(\x0b\x32\x19.raytpu_torch.WorkerHelloH\x00\x12(\n\x04\x65xec\x18\x02 \x01(\x0b\x32\x18.raytpu_torch.WorkerExecH\x00\x12(\n\x04\x64one\x18\x03 \x01(\x0b\x32\x18.raytpu_torch.WorkerDoneH\x00\x12\x30\n\x08shutdown\x18\x04 \x01(\x0b\x32\x1c.raytpu_torch.WorkerShutdownH\x00\x42\x05\n\x03msg\";\n\x0bInitRequest\x12\x13\n\x0b\x63lient_name\x18\x01 \x01(\t\x12\x17\n\x0f\x63lient_language\x18\x02 \x01(\t\"\xb3\x01\n\tInitReply\x12\x12\n\nsession_id\x18\x01 \x01(\x0c\x12\x0f\n\x07version\x18\x02 \x01(\t\x12H\n\x11\x63luster_resources\x18\x03 \x03(\x0b\x32-.raytpu_torch.InitReply.ClusterResourcesEntry\x1a\x37\n\x15\x43lusterResourcesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01:\x02\x38\x01\"0\n\nPutRequest\x12\"\n\x05value\x18\x01 \x01(\x0b\x32\x13.raytpu_torch.Value\"\x1d\n\x08PutReply\x12\x11\n\tobject_id\x18\x01 \x01(\x0c\"2\n\nGetRequest\x12\x11\n\tobject_id\x18\x01 \x01(\x0c\x12\x11\n\ttimeout_s\x18\x02 \x01(\x01\"=\n\x08GetReply\x12\"\n\x05value\x18\x01 \x01(\x0b\x32\x13.raytpu_torch.Value\x12\r\n\x05\x66ound\x18\x02 \x01(\x08\"\xd9\x01\n\rSubmitRequest\x12\x0f\n\x07\x66n_name\x18\x01 \x01(\t\x12\x1f\n\x04\x61rgs\x18\x02 \x03(\x0b\x32\x11.raytpu_torch.Arg\x12\x13\n\x0bnum_returns\x18\x03 \x01(\x05\x12\x10\n\x08num_cpus\x18\x04 \x01(\x01\x12=\n\tresources\x18\x05 \x03(\x0b\x32*.raytpu_torch.SubmitRequest.ResourcesEntry\x1a\x30\n\x0eResourcesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01:\x02\x38\x01\"!\n\x0bSubmitReply\x12\x12\n\nreturn_ids\x18\x01 \x03(\x0c\"I\n\x0bWaitRequest\x12\x12\n\nobject_ids\x18\x01 \x03(\x0c\x12\x13\n\x0bnum_returns\x18\x02 \x01(\x05\x12\x11\n\ttimeout_s\x18\x03 \x01(\x01\"-\n\tWaitReply\x12\r\n\x05ready\x18\x01 \x03(\x0c\x12\x11\n\tnot_ready\x18\x02 \x03(\x0c\"\xa7\x02\n\x12\x43reateActorRequest\x12\x12\n\nclass_name\x18\x01 \x01(\t\x12\x1f\n\x04\x61rgs\x18\x02 \x03(\x0b\x32\x11.raytpu_torch.Arg\x12\x10\n\x08num_cpus\x18\x03 \x01(\x01\x12\x42\n\tresources\x18\x04 \x03(\x0b\x32/.raytpu_torch.CreateActorRequest.ResourcesEntry\x12\x14\n\x0cmax_restarts\x18\x05 \x01(\x05\x12\x0c\n\x04name\x18\x06 \x01(\t\x12\x1a\n\x12placement_group_id\x18\x07 \x01(\x0c\x12\x14\n\x0c\x62undle_index\x18\x08 \x01(\x05\x1a\x30\n\x0eResourcesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01:\x02\x38\x01\"$\n\x10\x43reateActorReply\x12\x10\n\x08\x61\x63tor_id\x18\x01 \x01(\x0c\"r\n\x06\x42undle\x12\x36\n\tresources\x18\x01 \x03(\x0b\x32#.raytpu_torch.Bundle.ResourcesEntry\x1a\x30\n\x0eResourcesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01:\x02\x38\x01\"}\n\x1b\x43reatePlacementGroupRequest\x12%\n\x07\x62undles\x18\x01 \x03(\x0b\x32\x14.raytpu_torch.Bundle\x12\x10\n\x08strategy\x18\x02 \x01(\t\x12\x0c\n\x04name\x18\x03 \x01(\t\x12\x17\n\x0fready_timeout_s\x18\x04 \x01(\x01\"F\n\x19\x43reatePlacementGroupReply\x12\x1a\n\x12placement_group_id\x18\x01 \x01(\x0c\x12\r\n\x05ready\x18\x02 \x01(\x08\"9\n\x1bRemovePlacementGroupRequest\x12\x1a\n\x12placement_group_id\x18\x01 \x01(\x0c\"\'\n\x19RemovePlacementGroupReply\x12\n\n\x02ok\x18\x01 \x01(\x08\"U\n\x10\x41\x63torCallRequest\x12\x10\n\x08\x61\x63tor_id\x18\x01 \x01(\x0c\x12\x0e\n\x06method\x18\x02 \x01(\t\x12\x1f\n\x04\x61rgs\x18\x03 \x03(\x0b\x32\x11.raytpu_torch.Arg\"#\n\x0e\x41\x63torCallReply\x12\x11\n\treturn_id\x18\x01 \x01(\x0c\"8\n\x10KillActorRequest\x12\x10\n\x08\x61\x63tor_id\x18\x01 \x01(\x0c\x12\x12\n\nno_restart\x18\x02 \x01(\x08\"\x1c\n\x0eKillActorReply\x12\n\n\x02ok\x18\x01 \x01(\x08\"*\n\x0cKvPutRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\r\n\x05value\x18\x02 \x01(\x0c\"\x1b\n\x0cKvGetRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\"*\n\nKvGetReply\x12\r\n\x05value\x18\x01 \x01(\x0c\x12\r\n\x05\x66ound\x18\x02 \x01(\x08\"\x18\n\nKvPutReply\x12\n\n\x02ok\x18\x01 \x01(\x08\"\x99\x05\n\rClientRequest\x12\x0e\n\x06req_id\x18\x01 \x01(\x04\x12)\n\x04init\x18\x02 \x01(\x0b\x32\x19.raytpu_torch.InitRequestH\x00\x12\'\n\x03put\x18\x03 \x01(\x0b\x32\x18.raytpu_torch.PutRequestH\x00\x12\'\n\x03get\x18\x04 \x01(\x0b\x32\x18.raytpu_torch.GetRequestH\x00\x12-\n\x06submit\x18\x05 \x01(\x0b\x32\x1b.raytpu_torch.SubmitRequestH\x00\x12)\n\x04wait\x18\x06 \x01(\x0b\x32\x19.raytpu_torch.WaitRequestH\x00\x12,\n\x06kv_put\x18\x07 \x01(\x0b\x32\x1a.raytpu_torch.KvPutRequestH\x00\x12,\n\x06kv_get\x18\x08 \x01(\x0b\x32\x1a.raytpu_torch.KvGetRequestH\x00\x12\x38\n\x0c\x63reate_actor\x18\t \x01(\x0b\x32 .raytpu_torch.CreateActorRequestH\x00\x12\x34\n\nactor_call\x18\n \x01(\x0b\x32\x1e.raytpu_torch.ActorCallRequestH\x00\x12\x34\n\nkill_actor\x18\x0b \x01(\x0b\x32\x1e.raytpu_torch.KillActorRequestH\x00\x12K\n\x16\x63reate_placement_group\x18\x0c \x01(\x0b\x32).raytpu_torch.CreatePlacementGroupRequestH\x00\x12K\n\x16remove_placement_group\x18\r \x01(\x0b\x32).raytpu_torch.RemovePlacementGroupRequestH\x00\x42\x05\n\x03req\"\x90\x05\n\x0b\x43lientReply\x12\x0e\n\x06req_id\x18\x01 \x01(\x04\x12\r\n\x05\x65rror\x18\x02 \x01(\t\x12\'\n\x04init\x18\x03 \x01(\x0b\x32\x17.raytpu_torch.InitReplyH\x00\x12%\n\x03put\x18\x04 \x01(\x0b\x32\x16.raytpu_torch.PutReplyH\x00\x12%\n\x03get\x18\x05 \x01(\x0b\x32\x16.raytpu_torch.GetReplyH\x00\x12+\n\x06submit\x18\x06 \x01(\x0b\x32\x19.raytpu_torch.SubmitReplyH\x00\x12\'\n\x04wait\x18\x07 \x01(\x0b\x32\x17.raytpu_torch.WaitReplyH\x00\x12*\n\x06kv_get\x18\x08 \x01(\x0b\x32\x18.raytpu_torch.KvGetReplyH\x00\x12*\n\x06kv_put\x18\t \x01(\x0b\x32\x18.raytpu_torch.KvPutReplyH\x00\x12\x36\n\x0c\x63reate_actor\x18\n \x01(\x0b\x32\x1e.raytpu_torch.CreateActorReplyH\x00\x12\x32\n\nactor_call\x18\x0b \x01(\x0b\x32\x1c.raytpu_torch.ActorCallReplyH\x00\x12\x32\n\nkill_actor\x18\x0c \x01(\x0b\x32\x1c.raytpu_torch.KillActorReplyH\x00\x12I\n\x16\x63reate_placement_group\x18\r \x01(\x0b\x32\'.raytpu_torch.CreatePlacementGroupReplyH\x00\x12I\n\x16remove_placement_group\x18\x0e \x01(\x0b\x32\'.raytpu_torch.RemovePlacementGroupReplyH\x00\x42\x07\n\x05replyb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'ray_tpu_torch.protocol.raytpu_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TASKARGS_KWARGSENTRY._options = None
  _TASKARGS_KWARGSENTRY._serialized_options = b'8\001'
  _TASKSPEC_RESOURCESENTRY._options = None
  _TASKSPEC_RESOURCESENTRY._serialized_options = b'8\001'
  _ACTORCREATIONSPEC_RESOURCESENTRY._options = None
  _ACTORCREATIONSPEC_RESOURCESENTRY._serialized_options = b'8\001'
  _REGISTERNODE_RESOURCESENTRY._options = None
  _REGISTERNODE_RESOURCESENTRY._serialized_options = b'8\001'
  _INITREPLY_CLUSTERRESOURCESENTRY._options = None
  _INITREPLY_CLUSTERRESOURCESENTRY._serialized_options = b'8\001'
  _SUBMITREQUEST_RESOURCESENTRY._options = None
  _SUBMITREQUEST_RESOURCESENTRY._serialized_options = b'8\001'
  _CREATEACTORREQUEST_RESOURCESENTRY._options = None
  _CREATEACTORREQUEST_RESOURCESENTRY._serialized_options = b'8\001'
  _BUNDLE_RESOURCESENTRY._options = None
  _BUNDLE_RESOURCESENTRY._serialized_options = b'8\001'
  _VALUE._serialized_start=53
  _VALUE._serialized_end=90
  _ARG._serialized_start=92
  _ARG._serialized_end=163
  _TASKARGS._serialized_start=166
  _TASKARGS._serialized_end=327
  _TASKARGS_KWARGSENTRY._serialized_start=263
  _TASKARGS_KWARGSENTRY._serialized_end=327
  _TASKSPEC._serialized_start=330
  _TASKSPEC._serialized_end=912
  _TASKSPEC_RESOURCESENTRY._serialized_start=864
  _TASKSPEC_RESOURCESENTRY._serialized_end=912
  _ACTORCREATIONSPEC._serialized_start=915
  _ACTORCREATIONSPEC._serialized_end=1494
  _ACTORCREATIONSPEC_RESOURCESENTRY._serialized_start=864
  _ACTORCREATIONSPEC_RESOURCESENTRY._serialized_end=912
  _REGISTERNODE._serialized_start=1497
  _REGISTERNODE._serialized_end=1927
  _REGISTERNODE_RESOURCESENTRY._serialized_start=864
  _REGISTERNODE_RESOURCESENTRY._serialized_end=912
  _REGISTERNODE_WORKERINVENTORY._serialized_start=1838
  _REGISTERNODE_WORKERINVENTORY._serialized_end=1927
  _HEARTBEAT._serialized_start=1929
  _HEARTBEAT._serialized_end=2048
  _CLUSTERVIEWENTRY._serialized_start=2051
  _CLUSTERVIEWENTRY._serialized_end=2244
  _CLUSTERVIEW._serialized_start=2246
  _CLUSTERVIEW._serialized_end=2325
  _LEASESPILLED._serialized_start=2328
  _LEASESPILLED._serialized_end=2474
  _LEASESPILLED_MOVE._serialized_start=2392
  _LEASESPILLED_MOVE._serialized_end=2474
  _TASKEVENT._serialized_start=2476
  _TASKEVENT._serialized_end=2597
  _TASKEVENTS._serialized_start=2599
  _TASKEVENTS._serialized_end=2669
  _METRICSUPDATE._serialized_start=2672
  _METRICSUPDATE._serialized_end=2854
  _METRICSUPDATE_METRIC._serialized_start=2742
  _METRICSUPDATE_METRIC._serialized_end=2854
  _DIRECTACTORCALL._serialized_start=2856
  _DIRECTACTORCALL._serialized_end=2911
  _DIRECTACTORREPLY._serialized_start=2914
  _DIRECTACTORREPLY._serialized_end=3048
  _DIRECTACTORREPLY_DONE._serialized_start=2986
  _DIRECTACTORREPLY_DONE._serialized_end=3048
  _SHARDHELLO._serialized_start=3050
  _SHARDHELLO._serialized_end=3080
  _SHARDREADY._serialized_start=3082
  _SHARDREADY._serialized_end=3142
  _SHARDASSIGN._serialized_start=3144
  _SHARDASSIGN._serialized_end=3189
  _SHARDDIRADD._serialized_start=3191
  _SHARDDIRADD._serialized_end=3299
  _SHARDDIRADD_ENTRY._serialized_start=3256
  _SHARDDIRADD_ENTRY._serialized_end=3299
  _SHARDDIRDROP._serialized_start=3301
  _SHARDDIRDROP._serialized_end=3335
  _SHARDTEVINGEST._serialized_start=3337
  _SHARDTEVINGEST._serialized_end=3428
  _SHARDTEVDRAIN._serialized_start=3430
  _SHARDTEVDRAIN._serialized_end=3461
  _SHARDTEVBATCH._serialized_start=3463
  _SHARDTEVBATCH._serialized_end=3532
  _SHARDSNAPSHOT._serialized_start=3534
  _SHARDSNAPSHOT._serialized_end=3565
  _SHARDSTATE._serialized_start=3567
  _SHARDSTATE._serialized_end=3671
  _SHARDSHUTDOWN._serialized_start=3673
  _SHARDSHUTDOWN._serialized_end=3688
  _NODEACK._serialized_start=3690
  _NODEACK._serialized_end=3721
  _WORKERDEATH._serialized_start=3723
  _WORKERDEATH._serialized_end=3755
  _SPAWNWORKER._serialized_start=3757
  _SPAWNWORKER._serialized_end=3804
  _KILLWORKER._serialized_start=3806
  _KILLWORKER._serialized_end=3837
  _FETCHOBJECT._serialized_start=3839
  _FETCHOBJECT._serialized_end=3924
  _OBJECTFETCHED._serialized_start=3926
  _OBJECTFETCHED._serialized_end=3989
  _FREEOBJECT._serialized_start=3991
  _FREEOBJECT._serialized_end=4022
  _SEQSKIP._serialized_start=4024
  _SEQSKIP._serialized_end=4079
  _AGENTFRAME._serialized_start=4082
  _AGENTFRAME._serialized_end=4786
  _WORKERHELLO._serialized_start=4788
  _WORKERHELLO._serialized_end=4868
  _WORKEREXEC._serialized_start=4870
  _WORKEREXEC._serialized_end=4920
  _WORKEROUT._serialized_start=4922
  _WORKEROUT._serialized_end=5004
  _WORKERDONE._serialized_start=5007
  _WORKERDONE._serialized_end=5165
  _WORKERSHUTDOWN._serialized_start=5167
  _WORKERSHUTDOWN._serialized_end=5183
  _WORKERFRAME._serialized_start=5186
  _WORKERFRAME._serialized_end=5384
  _INITREQUEST._serialized_start=5386
  _INITREQUEST._serialized_end=5445
  _INITREPLY._serialized_start=5448
  _INITREPLY._serialized_end=5627
  _INITREPLY_CLUSTERRESOURCESENTRY._serialized_start=5572
  _INITREPLY_CLUSTERRESOURCESENTRY._serialized_end=5627
  _PUTREQUEST._serialized_start=5629
  _PUTREQUEST._serialized_end=5677
  _PUTREPLY._serialized_start=5679
  _PUTREPLY._serialized_end=5708
  _GETREQUEST._serialized_start=5710
  _GETREQUEST._serialized_end=5760
  _GETREPLY._serialized_start=5762
  _GETREPLY._serialized_end=5823
  _SUBMITREQUEST._serialized_start=5826
  _SUBMITREQUEST._serialized_end=6043
  _SUBMITREQUEST_RESOURCESENTRY._serialized_start=864
  _SUBMITREQUEST_RESOURCESENTRY._serialized_end=912
  _SUBMITREPLY._serialized_start=6045
  _SUBMITREPLY._serialized_end=6078
  _WAITREQUEST._serialized_start=6080
  _WAITREQUEST._serialized_end=6153
  _WAITREPLY._serialized_start=6155
  _WAITREPLY._serialized_end=6200
  _CREATEACTORREQUEST._serialized_start=6203
  _CREATEACTORREQUEST._serialized_end=6498
  _CREATEACTORREQUEST_RESOURCESENTRY._serialized_start=864
  _CREATEACTORREQUEST_RESOURCESENTRY._serialized_end=912
  _CREATEACTORREPLY._serialized_start=6500
  _CREATEACTORREPLY._serialized_end=6536
  _BUNDLE._serialized_start=6538
  _BUNDLE._serialized_end=6652
  _BUNDLE_RESOURCESENTRY._serialized_start=864
  _BUNDLE_RESOURCESENTRY._serialized_end=912
  _CREATEPLACEMENTGROUPREQUEST._serialized_start=6654
  _CREATEPLACEMENTGROUPREQUEST._serialized_end=6779
  _CREATEPLACEMENTGROUPREPLY._serialized_start=6781
  _CREATEPLACEMENTGROUPREPLY._serialized_end=6851
  _REMOVEPLACEMENTGROUPREQUEST._serialized_start=6853
  _REMOVEPLACEMENTGROUPREQUEST._serialized_end=6910
  _REMOVEPLACEMENTGROUPREPLY._serialized_start=6912
  _REMOVEPLACEMENTGROUPREPLY._serialized_end=6951
  _ACTORCALLREQUEST._serialized_start=6953
  _ACTORCALLREQUEST._serialized_end=7038
  _ACTORCALLREPLY._serialized_start=7040
  _ACTORCALLREPLY._serialized_end=7075
  _KILLACTORREQUEST._serialized_start=7077
  _KILLACTORREQUEST._serialized_end=7133
  _KILLACTORREPLY._serialized_start=7135
  _KILLACTORREPLY._serialized_end=7163
  _KVPUTREQUEST._serialized_start=7165
  _KVPUTREQUEST._serialized_end=7207
  _KVGETREQUEST._serialized_start=7209
  _KVGETREQUEST._serialized_end=7236
  _KVGETREPLY._serialized_start=7238
  _KVGETREPLY._serialized_end=7280
  _KVPUTREPLY._serialized_start=7282
  _KVPUTREPLY._serialized_end=7306
  _CLIENTREQUEST._serialized_start=7309
  _CLIENTREQUEST._serialized_end=7974
  _CLIENTREPLY._serialized_start=7977
  _CLIENTREPLY._serialized_end=8633
# @@protoc_insertion_point(module_scope)
